from vae_connexe_torch.data.henon import (
    coupled_henon,
    coupled_henon_truth,
    henon_chain,
    henon_dynamics_truth,
    henon_truth,
)
from vae_connexe_torch.data.lorenz96 import lorenz96, lorenz96_truth
from vae_connexe_torch.data.timegan_utils import (
    batch_generator,
    extract_time,
    train_test_divide,
)
from vae_connexe_torch.data.var import var_process, var_truth
from vae_connexe_torch.data.windows import arrange_input, sample_batch, sliding_windows

__all__ = ["arrange_input", "batch_generator", "coupled_henon",
           "coupled_henon_truth", "extract_time", "henon_chain",
           "henon_dynamics_truth", "henon_truth", "lorenz96",
           "lorenz96_truth", "sample_batch", "sliding_windows",
           "train_test_divide", "var_process", "var_truth"]
