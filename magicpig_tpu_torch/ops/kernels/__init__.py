"""Hand-written CUDA kernels of the port, one wrapper module each.

Each wrapper launches its kernel for CUDA tensors (building the library on
first use) and runs its plain PyTorch version for CPU tensors.
"""

from magicpig_tpu_torch.ops.kernels._lib import (  # noqa: F401
    LAUNCHES,
    W4_SHAPE_LAUNCHES,
    reset_launches,
)
from magicpig_tpu_torch.ops.kernels.flash_decode import flash_decode  # noqa: F401
from magicpig_tpu_torch.ops.kernels.flash_prefill import (  # noqa: F401
    FlashPrefillTrain,
    flash_prefill,
    flash_prefill_bwd,
    flash_prefill_train,
)
from magicpig_tpu_torch.ops.kernels.collision_words import collision_words  # noqa: F401
from magicpig_tpu_torch.ops.kernels.lsh_masked import lsh_masked_attention  # noqa: F401
from magicpig_tpu_torch.ops.kernels.lsh_fused import (  # noqa: F401
    lsh_decode,
    lsh_fused_decode,
)
from magicpig_tpu_torch.ops.kernels.block_score import (  # noqa: F401
    block_rank,
    exact_scores,
    exact_scores_ranked,
)
from magicpig_tpu_torch.ops.kernels.rescore_attend import rescore_attend  # noqa: F401
from magicpig_tpu_torch.ops.kernels.block_attend import block_attend  # noqa: F401
from magicpig_tpu_torch.ops.kernels.w4_matmul import w4_matmul  # noqa: F401
