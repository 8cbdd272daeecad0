"""cvaegan_tpu_torch — the PyTorch/CUDA port of `cvaegan_tpu`.

The JAX package stays the reference; this package imports nothing of it
(nor of JAX) and mirrors its module paths, so that each module's
counterpart is found at the same place. Entry points run on
`device="cuda"` unless the caller asks for the CPU, and the Pallas TPU
kernels become CUDA kernels written for Hopper (`csrc/`, built at first
use). Importing the package does not touch CUDA.
"""

from cvaegan_tpu_torch.algorithms.cvae_gan import CVAEGAN
from cvaegan_tpu_torch.algorithms.rain_gan import RAIN_GAN
from cvaegan_tpu_torch.eval.classifier import Classifier

__version__ = "0.1.0"

__all__ = ["CVAEGAN", "Classifier", "RAIN_GAN"]
