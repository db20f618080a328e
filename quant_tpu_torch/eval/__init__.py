"""Perplexity evaluation (the quality gate of a quantized checkpoint)."""

from quant_tpu_torch.eval.perplexity import perplexity, tokens_from_file

__all__ = ["perplexity", "tokens_from_file"]
