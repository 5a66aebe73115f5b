"""repro_torch.core — the paper's contribution: DBB structured sparsity
(port of ``repro.core``).

Public API, name for name the reference's:
    DBBConfig, prune, pack, unpack, topk_block_mask, block_density, satisfies
    DAPSpec, dap, apply_dap
    quantize, dequantize, symmetric_scale (shared int8 quant math)
    WDBBSchedule, prune_weights, wdbb_masks, apply_masks
    SparsityConfig, DENSE, WDBB_4_8, AWDBB_4_8

``core.dap`` reaches ``kernels.ops`` (kernel #5), whose modules import
``core``: ``dap`` imports ``ops`` at its first call, so ``core`` and
every ``kernels`` module may be imported first.
"""

from repro_torch.core.dbb import (  # noqa: F401
    DBBConfig,
    DEFAULT_BZ,
    PackedDBB,
    block_density,
    expand_bitmask,
    pack,
    pack_bitmask,
    prune,
    satisfies,
    topk_block_mask,
    unpack,
)
from repro_torch.core.dap import DAPSpec, apply_dap, dap  # noqa: F401
from repro_torch.core.quant import dequantize, quantize, symmetric_scale  # noqa: F401
from repro_torch.core.schedule import (  # noqa: F401
    WDBBSchedule,
    apply_masks,
    prune_weights,
    wdbb_masks,
)
from repro_torch.core.sparsity import (  # noqa: F401
    AWDBB_4_8,
    DENSE,
    SparsityConfig,
    WDBB_4_8,
)
