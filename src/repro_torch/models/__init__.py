"""Dense transformer LM (the port's model zoo so far)."""
from . import layers, transformer
from .layers import materialize
from .transformer import ModelConfig, forward, init_lm, lm_loss

__all__ = ["layers", "transformer", "ModelConfig", "init_lm", "forward",
           "lm_loss", "materialize"]
