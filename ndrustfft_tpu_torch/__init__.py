"""ndrustfft_tpu_torch: the n-D spectral transforms of ``ndrustfft_tpu`` in
PyTorch, with hand-written CUDA kernels for Hopper (H100).

The public surface is the JAX package's: ``ndfft``/``ndifft``,
``ndfft_r2c``/``ndifft_r2c``, ``nddct1..4`` and ``nddst1..4`` along one axis
(``api.py``), their ``_par`` twins (the serial functions: the port has no
sharded input), the fused spectral pipelines ``ndspectral_r2c``,
``ndspectral_c2c``, ``ndspectral_dct`` and ``ndspectral_dst`` (a forward
transform, a diagonal multiply by a multiplier H and the inverse along one
axis; along a middle axis one pass of kernel 22, 14 or 29, the spectrum
never in device memory), and the multi-axis ``fftn`` ... ``idstn``
(``ndapi.py``).

On a CUDA tensor every call runs the route ``api._route`` names: a CUDA
kernel of ``ops/hopper`` (the mixed-radix core on rows and column tiles: the
C2C at every length up to 20480, the R2C and C2R along rows and along a
middle axis, kernel 11's chirp-z; the bts2 core's fixed and wide forms: the
DCT-I/II/III/IV kernels and kernel 12's chirp-z, the four-step's kernels 7
and 13 beyond n = 20480, the fused spectral kernels 14, 22 and 29, the
DCT-II/III n-point and DCT-IV long forms on the wide core's real tile up to
n = 32640 and 65536; the dense products of the JAX package's short dense
routes), or the plain torch engine where the JAX package runs XLA: every
Pallas kernel of the JAX package has its CUDA port. A CPU tensor runs each
kernel's plain PyTorch version.

The dtype vocabulary (``float32`` ... ``complex128``, ``complex_dtype``,
``real_dtype``) is the JAX package's, as torch dtypes.
"""

from .api import (
    nddct1, nddct1_par, nddct2, nddct2_par, nddct3, nddct3_par, nddct4, nddct4_par, nddst1,
    nddst1_par, nddst2, nddst2_par, nddst3, nddst3_par, nddst4, nddst4_par, ndfft,
    ndfft_par, ndfft_r2c, ndfft_r2c_par, ndifft, ndifft_par, ndifft_r2c, ndifft_r2c_par,
    ndspectral_c2c, ndspectral_dct, ndspectral_dst, ndspectral_r2c,
)
from .config import config
from .dtypes import complex64, complex128, complex_dtype, float32, float64, real_dtype
from .handlers import DctHandler, DstHandler, FftHandler, R2cFftHandler
from .ndapi import dctn, dstn, fftn, idctn, idstn, ifftn, irfftn, rfftn
from .normalization import Normalization

__all__ = [
    "ndfft", "ndifft", "ndfft_r2c", "ndifft_r2c",
    "nddct1", "nddct2", "nddct3", "nddct4",
    "nddst1", "nddst2", "nddst3", "nddst4",
    "ndfft_par", "ndifft_par", "ndfft_r2c_par", "ndifft_r2c_par",
    "nddct1_par", "nddct2_par", "nddct3_par", "nddct4_par",
    "nddst1_par", "nddst2_par", "nddst3_par", "nddst4_par",
    "ndspectral_r2c", "ndspectral_c2c", "ndspectral_dct", "ndspectral_dst",
    "fftn", "ifftn", "rfftn", "irfftn", "dctn", "idctn", "dstn", "idstn",
    "FftHandler", "R2cFftHandler", "DctHandler", "DstHandler",
    "Normalization", "config",
    "float32", "float64", "complex64", "complex128",
    "complex_dtype", "real_dtype",
]
