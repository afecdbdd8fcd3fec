"""ndrustfft_tpu_torch: the n-D spectral transforms of ``ndrustfft_tpu`` in
PyTorch, with hand-written CUDA kernels for Hopper (H100).

The real spectral step of a pseudo-spectral solver runs on the card through
three kernels (``ops/hopper``): C2C along a middle axis, and R2C / C2R of
contiguous rows. The complex n-D transform (``ndfft``/``ndifft`` on every
axis) adds three: C2C of contiguous rows, and a dense C2C product (n <= 512)
along a middle axis or along rows; lengths above 256 without a {128, 256}
split take the generic two-factor schedule, along rows or a middle axis.
The DCT/DST family runs through three more: a dense DCT of any type along a
middle axis (n <= 1100), and DCT-II / DCT-III of contiguous rows. Everything
else runs the plain torch engine, or raises
``NotImplementedError`` on a CUDA tensor where the JAX package would use a
Pallas kernel that is not ported yet (see ``api._route`` and ROADMAP.md).
"""

from .api import (
    nddct1, nddct2, nddct3, nddct4, nddst1, nddst2, nddst3, nddst4, ndfft,
    ndfft_r2c, ndifft, ndifft_r2c,
)
from .config import config
from .handlers import DctHandler, DstHandler, FftHandler, R2cFftHandler
from .normalization import Normalization

__all__ = [
    "ndfft", "ndifft", "ndfft_r2c", "ndifft_r2c",
    "nddct1", "nddct2", "nddct3", "nddct4",
    "nddst1", "nddst2", "nddst3", "nddst4",
    "FftHandler", "R2cFftHandler", "DctHandler", "DstHandler",
    "Normalization", "config",
]
