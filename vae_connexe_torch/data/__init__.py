from vae_connexe_torch.data.henon import (
    coupled_henon,
    coupled_henon_truth,
    henon_chain,
    henon_dynamics_truth,
    henon_truth,
)
from vae_connexe_torch.data.lorenz96 import lorenz96, lorenz96_truth
from vae_connexe_torch.data.var import var_process, var_truth
from vae_connexe_torch.data.windows import arrange_input, sample_batch, sliding_windows

__all__ = ["arrange_input", "coupled_henon", "coupled_henon_truth",
           "henon_chain", "henon_dynamics_truth", "henon_truth", "lorenz96",
           "lorenz96_truth", "sample_batch", "sliding_windows", "var_process",
           "var_truth"]
