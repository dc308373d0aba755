"""Core numerics of the port: sparse formats, LIF, Σ-Δ, GOAP, pooling,
the streaming dataflow and the fetch/cycle/power cost models (the names
the reference's ``repro.core`` exports)."""

from .sparse_format import (
    CooKernel,
    coo_from_dense,
    coo_to_dense,
    coo_bit_widths,
    coo_storage_bits,
    dense_storage_bits,
    break_even_density,
    Schedule,
    build_schedule,
    WeightMask,
    weight_mask_from_dense,
    BlockSparseKernel,
    block_sparse_from_dense,
    block_sparse_to_dense,
)
from .goap import (
    conv1d_dense_oracle,
    build_shift_buffer,
    goap_conv_nnz,
    goap_conv_reference,
)
from .lif import LIFParams, init_lif_params, spike, lif_step, lif_unroll
from .encoder import (
    normalize_iq,
    sigma_delta_encode,
    sigma_delta_decode,
    encode_frames,
)
from .saocds import (
    pad_same,
    max_pool_spikes,
    saocds_conv_step,
    saocds_conv_layer,
    sw_conv_layer,
    wm_fc_step,
    wm_fc_layer,
    schedule_interpreter,
)
from .cost_model import (
    ConvCounts,
    sw_conv_counts,
    goap_conv_counts,
    fc_traditional_counts,
    fc_wm_counts,
    bits_fetched,
    CycleModel,
    PowerModel,
    PAPER_TABLE5,
    PAPER_BASELINE,
    fom,
)
