from vae_connexe_torch.train.crvae_trainer import (
    generate_from_draws,
    generate_with_compensation,
)

__all__ = ["generate_from_draws", "generate_with_compensation"]
