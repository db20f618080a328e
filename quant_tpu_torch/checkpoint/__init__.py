"""Packed checkpoint format (quant-tpu-ckpt-v2)."""

from quant_tpu_torch.checkpoint.format import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
