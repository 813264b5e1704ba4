"""The paper's own micro-benchmark problem shapes (Table 1 / Fig 7).

Not a ModelConfig -- these are the three SGEMM problem geometries the paper
batches into super-kernels, used by ``chip_smoke.py``'s Table 1 sweep and
the scheduler tests. The port's own copy of the JAX package's
``configs/paper_sgemm.py``; ``tests/test_torch_boundary.py`` holds the two
equal.
"""

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class GemmShape:
    name: str
    M: int
    N: int
    K: int

    @property
    def flops(self) -> int:
        return 2 * self.M * self.N * self.K


# Table 1 geometries (verbatim from the paper).
PAPER_GEMM_SHAPES: Dict[str, GemmShape] = {
    # "Matrix-vector: RNN" M=512, N=1, K=512
    "rnn_matvec": GemmShape("rnn_matvec", M=512, N=1, K=512),
    # "ResNet-18 conv2_2" im2col SGEMM: M=256, N=128, K=1152
    # (128x128 input image, 3x3 kernel, 128 in/out channels)
    "resnet18_conv2_2": GemmShape("resnet18_conv2_2", M=256, N=128, K=1152),
    # "Square matrix-matrix" M=N=K=256
    "square_256": GemmShape("square_256", M=256, N=256, K=256),
}

# R sweep used for the Table 1 geomean rows: 2 <= R <= 120.
PAPER_R_SWEEP = (2, 4, 8, 10, 16, 20, 32, 48, 64, 96, 120)
