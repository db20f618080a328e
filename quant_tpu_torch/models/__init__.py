"""Model configs and the dense Llama family."""

from quant_tpu_torch.models.config import PRESETS, ModelConfig

__all__ = ["PRESETS", "ModelConfig"]
