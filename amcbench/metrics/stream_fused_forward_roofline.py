"""``stream_fused_forward_roofline`` (%): the whole-network kernel's share
of its roofline over the traced window (``amcbench/roofline.py``)."""
from amcbench.roofline import share


def read(run, name):
    return share(run, "stream_fused_forward")
