"""The paper's own workload: 2-D Jacobi / Laplace diffusion solver
(twin of ``repro.configs.jacobi2d``)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class JacobiConfig:
    ny: int = 1024            # paper §VII: 1024 x 9216 global domain
    nx: int = 9216
    iters: int = 5000
    dtype: str = "bfloat16"   # e150's precision ceiling (paper runs BF16)
    kernel: str = "v1"        # ref | v0 | v1 | v1db | v2
    temporal: int = 8         # v2 fusion depth
    halo_depth: int = 1       # distributed exchange depth


def config() -> JacobiConfig:
    return JacobiConfig()


def smoke() -> JacobiConfig:
    return JacobiConfig(ny=64, nx=128, iters=20, dtype="float32")
