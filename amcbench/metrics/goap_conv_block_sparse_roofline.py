"""``goap_conv_block_sparse_roofline`` (%): the float32 conv form's share of
its roofline over the traced window (``amcbench/roofline.py``)."""
from amcbench.roofline import share


def read(run, name):
    return share(run, "goap_conv_block_sparse")
