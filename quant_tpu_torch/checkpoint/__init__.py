"""Packed checkpoint format (quant-tpu-ckpt-v2) and the HF converter."""

from quant_tpu_torch.checkpoint.format import (CheckpointWriter,
                                               load_checkpoint,
                                               save_checkpoint)
from quant_tpu_torch.checkpoint.hf import convert_hf_llama

__all__ = ["CheckpointWriter", "convert_hf_llama", "load_checkpoint",
           "save_checkpoint"]
