from vae_connexe_torch.data.lorenz96 import lorenz96, lorenz96_truth
from vae_connexe_torch.data.windows import arrange_input, sample_batch, sliding_windows

__all__ = ["arrange_input", "lorenz96", "lorenz96_truth", "sample_batch",
           "sliding_windows"]
