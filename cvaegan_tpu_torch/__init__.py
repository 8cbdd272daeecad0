"""cvaegan_tpu_torch — the PyTorch/CUDA port of `cvaegan_tpu`.

The JAX package stays the reference; this package imports nothing of it
(nor of JAX) and mirrors its module paths, so that each module's
counterpart is found at the same place. Entry points run on
`device="cuda"` unless the caller asks for the CPU, and the Pallas TPU
kernels become CUDA kernels written for Hopper (`csrc/`, built at first
use). Importing the package does not touch CUDA.
"""

from cvaegan_tpu_torch.algorithms.cgan import CGAN
from cvaegan_tpu_torch.algorithms.ctgan import CTGAN
from cvaegan_tpu_torch.algorithms.cvae import CVAE
from cvaegan_tpu_torch.algorithms.cvae_gan import CVAEGAN
from cvaegan_tpu_torch.algorithms.gan import GAN
from cvaegan_tpu_torch.algorithms.qg_smote import QG_SMOTE
from cvaegan_tpu_torch.algorithms.rain_gan import RAIN_GAN
from cvaegan_tpu_torch.algorithms.seed_bank import SeedBank
from cvaegan_tpu_torch.algorithms.sngan import SNGAN
from cvaegan_tpu_torch.algorithms.tmg_gan import TMGGAN
from cvaegan_tpu_torch.algorithms.vae import VAE
from cvaegan_tpu_torch.algorithms.vae_gan import VAEGAN
from cvaegan_tpu_torch.eval.classifier import Classifier
from cvaegan_tpu_torch.utils.logger import Logger

__version__ = "0.1.0"

__all__ = ["CGAN", "CTGAN", "CVAE", "CVAEGAN", "Classifier", "GAN", "Logger", "QG_SMOTE",
           "RAIN_GAN", "SNGAN", "SeedBank", "TMGGAN", "VAE", "VAEGAN"]
