"""The port's core (codec, QTensor, entropy) against the JAX package (CPU).

Inputs are numpy arrays from a seeded ``np.random.default_rng``; codes and
scales must match bit for bit, dequantized values exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from quant_tpu.core import codec as j_codec
from quant_tpu.core import entropy as j_entropy
from quant_tpu.core import qtensor as j_qtensor
from quant_tpu_torch.core import codec as t_codec
from quant_tpu_torch.core import entropy as t_entropy
from quant_tpu_torch.core import qtensor as t_qtensor


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("group_size", [None, 64])
def test_codec_bit_exact_1m_floats(bits, group_size):
    """BASELINE.json configs[0]: a 1M-float32 array through quantize,
    byte-pack, unpack, dequantize."""
    x = np.random.default_rng(0).standard_normal(1 << 20).astype(np.float32)
    if group_size:
        x = x.reshape(-1, 1024)
    jc, js = j_codec.quantize(x, bits, group_size=group_size)
    tc, ts = t_codec.quantize(x, bits, group_size=group_size)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)
    if bits == 4:
        packed = t_codec.pack_int4(tc)
        np.testing.assert_array_equal(packed, j_codec.pack_int4(jc))
        np.testing.assert_array_equal(
            t_codec.unpack_int4(packed, tc.size), jc.reshape(-1))
    np.testing.assert_array_equal(
        t_codec.dequantize(tc, ts, group_size=group_size),
        j_codec.dequantize(jc, js, group_size=group_size))


def _port_qt(jq) -> t_qtensor.QTensor:
    return t_qtensor.QTensor(
        codes=torch.from_numpy(np.asarray(jq.codes)),
        scales=torch.from_numpy(np.asarray(jq.scales)), bits=jq.bits,
        group_size=jq.group_size, shape=jq.shape, kshards=jq.kshards)


@pytest.mark.parametrize("bits,kshards", [(8, 1), (4, 1), (4, 2)])
def test_qtensor_dequantize_matches(bits, kshards):
    w = np.random.default_rng(bits + kshards).standard_normal(
        (256, 384)).astype(np.float32)
    jq = j_qtensor.quantize_tensor(w, bits, group_size=64, kshards=kshards)
    tq = t_qtensor.quantize_tensor(w, bits, group_size=64, kshards=kshards)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(_port_qt(jq).dequantize().numpy(),
                                  np.asarray(jq.dequantize()))


@pytest.mark.parametrize("bits", [4, 8])
def test_local_view_matches(bits):
    """A row shard of a kshards=2 tensor, still carrying the global
    metadata: the local view rebuilds shape and group size like the JAX
    package's, and dequantizes to the same values."""
    w = np.random.default_rng(bits).standard_normal((256, 128)).astype(
        np.float32)
    jq = j_qtensor.quantize_tensor(w, bits, group_size=64, kshards=2)
    kp, g = jq.codes.shape[0] // 2, jq.scales.shape[0] // 2
    j_shard = dataclasses.replace(jq, codes=jq.codes[kp:],
                                  scales=jq.scales[g:]).local_view()
    t_shard = dataclasses.replace(_port_qt(jq),
                                  codes=torch.from_numpy(np.asarray(
                                      jq.codes[kp:])),
                                  scales=torch.from_numpy(np.asarray(
                                      jq.scales[g:]))).local_view()
    assert (t_shard.shape, t_shard.group_size, t_shard.kshards) == (
        j_shard.shape, j_shard.group_size, j_shard.kshards)
    np.testing.assert_array_equal(t_shard.dequantize().numpy(),
                                  np.asarray(j_shard.dequantize()))


@pytest.mark.parametrize("bits,group_size,kshards",
                         [(8, 64, 1), (4, 128, 1), (4, 64, 2), (4, None, 1)])
def test_quantize_tensor_device_bit_exact(bits, group_size, kshards):
    """The torch quantizer on CPU tensors against the host numpy codec."""
    w = np.random.default_rng(7).standard_normal((512, 256)).astype(
        np.float32)
    w[:, 3] = 0.0   # an all-zero column takes the scale-1 guard
    jq = j_qtensor.quantize_tensor(w, bits, group_size=group_size,
                                   kshards=kshards)
    tq = t_qtensor.quantize_tensor_device(torch.from_numpy(w), bits,
                                          group_size=group_size,
                                          kshards=kshards)
    assert tq.codes.dtype == (torch.uint8 if bits == 4 else torch.int8)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert (tq.shape, tq.group_size, tq.kshards) == (
        jq.shape, jq.group_size, jq.kshards)


@pytest.mark.parametrize("kind", ["skewed", "uniform", "empty"])
def test_entropy_decode_reads_jax_encode(kind):
    rng = np.random.default_rng(3)
    if kind == "skewed":
        data = np.clip(rng.normal(128, 6, 50000), 0, 255).astype(np.uint8)
    elif kind == "uniform":     # stored (raw) frames
        data = rng.integers(0, 256, 4096).astype(np.uint8)
    else:
        data = np.zeros(0, np.uint8)
    comp = j_entropy.encode(data)
    assert t_entropy.decode(comp) == data.tobytes()
    assert t_entropy.encode(data) == comp


def test_entropy_decode_memory_is_bounded_by_its_chunk():
    """A blob of several chunks decodes exactly, codes that cross a chunk's
    end included, and the decoder's peak memory stays that of one chunk
    (about 30 bytes per bit position) and not of the whole blob."""
    import tracemalloc
    rng = np.random.default_rng(4)
    data = np.clip(rng.normal(128, 20, 1_000_000), 0, 255).astype(np.uint8)
    comp = t_entropy.encode(data)
    assert 8 * len(comp) > 5 * t_entropy._CHUNK_BITS          # 6 chunks
    max_len = int(np.frombuffer(comp, np.uint8, 256, 14).max())
    tracemalloc.start()
    try:
        got = t_entropy.decode(comp)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert got == data.tobytes()
    # the output, one chunk's arrays and the table (measured 23 MiB); the
    # whole blob's 6.1M positions at once took 95 MiB
    assert peak < len(data) + 32 * t_entropy._CHUNK_BITS + 2 * 2 ** max_len


@pytest.mark.parametrize("bits", [4, 8])
def test_oracle_binding_bit_exact_1m_floats(bits):
    """The port's binding to the C++ oracle (built from ``cpp/`` into the
    port's build directory): 1M-float codes and scales, per tensor and per
    group of 64, bit-exact against the port's numpy codec; nibble packing
    both ways; the MSE within the uniform-quantization bound."""
    from quant_tpu_torch.core import oracle

    assert oracle.available()
    x = np.random.default_rng(bits).standard_normal(1 << 20).astype(
        np.float32)
    c_codes, c_scale = oracle.quantize(x, bits)
    p_codes, p_scale = t_codec.quantize(x, bits)
    np.testing.assert_array_equal(c_codes, p_codes)
    assert c_scale == float(p_scale)
    g_codes, g_scales = oracle.quantize_grouped(x.reshape(-1, 1024), bits,
                                                64)
    p_codes, p_scales = t_codec.quantize(x.reshape(-1, 1024), bits,
                                         group_size=64)
    np.testing.assert_array_equal(g_codes, p_codes)
    np.testing.assert_array_equal(g_scales, p_scales)
    rec = oracle.dequantize(c_codes, c_scale)
    np.testing.assert_array_equal(rec, t_codec.dequantize(c_codes, c_scale))
    assert oracle.mse(x, rec) <= (c_scale / 2) ** 2
    if bits == 4:
        packed = oracle.pack_int4(c_codes)
        np.testing.assert_array_equal(packed, t_codec.pack_int4(c_codes))
        np.testing.assert_array_equal(oracle.unpack_int4(packed, x.size),
                                      c_codes)


@pytest.mark.parametrize("kind", ["int4", "int8", "stored", "empty"])
def test_oracle_entropy_byte_equal_to_python_coder(kind):
    """``oracle.entropy_encode`` writes the same QREF frame as the port's
    Python coder (Huffman for quantized codes, stored for incompressible
    bytes); each coder decodes the other's frame."""
    from quant_tpu_torch.core import oracle

    rng = np.random.default_rng(5)
    if kind == "empty":
        data = np.zeros(0, np.uint8)
    elif kind == "stored":
        data = rng.integers(0, 256, 4096).astype(np.uint8)
    else:
        bits = 4 if kind == "int4" else 8
        codes, _ = t_codec.quantize(
            rng.standard_normal(1 << 16).astype(np.float32), bits)
        data = (t_codec.pack_int4(codes) if bits == 4
                else codes.view(np.uint8))
    frame = oracle.entropy_encode(data)
    assert frame == t_entropy.encode(data)
    assert oracle.entropy_decode(frame) == data.tobytes()
    assert t_entropy.decode(frame) == data.tobytes()
