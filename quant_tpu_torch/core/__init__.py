"""Codec core: quantization, packing, entropy coding, QTensor."""
