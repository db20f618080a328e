"""The port's dense Llama forward against the JAX reference (CPU).

Both packages get the same parameters: the JAX ``init_params`` weights are
flattened in checkpoint naming and carried across by ``params_from_flat``.
One prefill chunk, then three decode steps, through JAX
``llama.forward(kernel_mode="xla")`` and the port's ``forward`` in its plain
mode ("xla") and its kernel mode ("auto", which on CPU tensors takes each
kernel wrapper's plain version).

Tolerances (float32): logits within 1e-4 * max|logit|; KV codes equal except
in at most 0.1% of entries, which differ by exactly 1; scales within 1e-5
relative. A code that differs sits on a rounding tie of ``quantize_kv``
(its input differs by an ulp: the two frameworks sum the projection in
another order), and every later position of that slot then reads a value
one int8 step away. Those positions are held to 1e-3 * max|logit|, the
effect of one code step; positions before the slot's first differing code
are held to 1e-4. Measured on these inputs: test-tiny has two differing
codes, and the 14 logit rows after them are off by at most 7.2e-4 of
max|logit|; hd128-rep4 has none; every other row is within 1.1e-6.
bfloat16: logits within 3e-2 * max|logit|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.checkpoint.format import _flatten_params
from quant_tpu.models import PRESETS as JPRESETS
from quant_tpu.models import llama as jllama
from quant_tpu.models.config import ModelConfig as JConfig
from quant_tpu_torch.models import llama as tllama
from quant_tpu_torch.models.config import ModelConfig as TConfig
from quant_tpu_torch.models.transfer import params_from_flat

# Llama-3-8B's head geometry at narrow width: head_dim 128, GQA rep 4,
# group 128, llama3 rope scaling
_HD128 = dict(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=1,
              intermediate=512, head_dim=128, group_size=128,
              rope_theta=500000.0, rope_scaling="llama3", rope_factor=8.0,
              kernel_mode="xla")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name, dtype):
    if name == "test-tiny":
        jc = dataclasses.replace(JPRESETS["test-tiny"], dtype=dtype)
    else:
        jc = JConfig(**_HD128, dtype=dtype)
    return jc, TConfig(**dataclasses.asdict(jc))


def _flat(jparams):
    return jax.tree.map(np.asarray, _flatten_params(jparams))


def _run_jax(jparams, jc, prompt, steps, max_seq):
    cache = jllama.init_cache(jc, prompt.shape[0], max_seq)
    outs = []
    lg, cache = jllama.forward(jparams, jnp.asarray(prompt), cache, jc)
    outs.append(np.asarray(lg, np.float32))
    for s in steps:
        lg, cache = jllama.forward(jparams, jnp.asarray(s), cache, jc)
        outs.append(np.asarray(lg, np.float32))
    return outs, jax.tree.map(np.asarray, cache)


def _run_port(tparams, tc, prompt, steps, max_seq):
    cache = tllama.init_cache(tc, prompt.shape[0], max_seq, "cpu")
    outs = []
    lg, cache = tllama.forward(tparams, torch.from_numpy(prompt), cache, tc,
                               device="cpu")
    outs.append(lg.float().numpy())
    for s in steps:
        lg, cache = tllama.forward(tparams, torch.from_numpy(s), cache, tc,
                                   device="cpu")
        outs.append(lg.float().numpy())
    return outs, cache


def test_config_matches_jax():
    """Field names, defaults and every preset equal the reference's, so a
    checkpoint manifest parses the same in both packages."""
    from quant_tpu_torch.models import PRESETS as TPRESETS

    names = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]
    assert names(TConfig) == names(JConfig)
    assert TPRESETS.keys() == JPRESETS.keys()
    for k in JPRESETS:
        assert dataclasses.asdict(TPRESETS[k]) == dataclasses.asdict(
            JPRESETS[k]), k


@pytest.mark.parametrize("preset,change,kwargs", [
    ("test-tiny-moe", {"moe_fused": False}, {}),
    ("test-tiny-mla", {"kv_bits": 16}, {}),
    ("test-tiny", {"kv_bits": 4}, {}),
    ("test-tiny", {"kv_bits": 16}, {}),
    ("test-tiny", {"sliding_window": 8}, {}),
    ("test-tiny", {"attn_softcap": 50.0}, {}),
    ("test-tiny", {"act_quant": True}, {}),
    ("test-tiny", {"n_experts": 4, "moe_prefill": "capacity"}, {}),
    ("test-tiny", {}, {"seq_axis": "seq"}),
    ("test-tiny", {}, {"axis": "model"}),
])
def test_outside_the_slice_raises(preset, change, kwargs):
    """A config or argument outside the ported slices (dense and sparse-MoE
    Llama, DeepSeek MLA, int8 KV) raises NotImplementedError; nothing falls
    back silently. MoE, qk_norm and MLA are ported: their cases ask for the
    parts that are not (the per-expert loop, the capacity dispatch, an
    unquantized latent cache)."""
    cfg = dataclasses.replace(TConfig(**dataclasses.asdict(
        JPRESETS[preset])), **change)
    base = TConfig(**dataclasses.asdict(JPRESETS["test-tiny"]))
    params = tllama.init_params(base, seed=0, device="cpu")
    cache = tllama.init_cache(base, 1, 16, device="cpu")
    with pytest.raises(NotImplementedError):
        tllama.forward(params, [[1, 2]], cache, cfg, device="cpu", **kwargs)


@pytest.mark.parametrize("scaling", ["none", "llama3"])
def test_rope_matches_jax(scaling):
    """Same inverse frequencies bit for bit; rotated values within 1e-5
    (cos/sin of one float32 angle in two libraries)."""
    jc, tc = _configs("hd128-rep4", "float32")
    jc = dataclasses.replace(jc, rope_scaling=scaling)
    tc = dataclasses.replace(tc, rope_scaling=scaling)
    np.testing.assert_array_equal(
        tllama._rope_freqs(tc.rope_theta, 64, tc),
        np.asarray(jllama._rope_freqs(jc.rope_theta, 64, jc)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 128)).astype(np.float32)
    pos = rng.integers(0, 8192, (2, 5)).astype(np.int32)
    ref = np.asarray(jllama._rope(jnp.asarray(x), jnp.asarray(pos),
                                  jc.rope_theta, jc))
    got = tllama._rope(torch.from_numpy(x), torch.from_numpy(pos),
                       tc.rope_theta, tc).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-5


@pytest.mark.parametrize("name", ["test-tiny", "hd128-rep4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(name, dtype):
    jc, tc = _configs(name, dtype)
    jparams = jllama.init_params(jc, seed=3)
    tparams = params_from_flat(_flat(jparams), tc, "cpu")
    rng = np.random.default_rng(7)
    b, t, max_seq = 2, 12, 64
    prompt = rng.integers(0, jc.vocab_size, (b, t)).astype(np.int32)
    steps = [rng.integers(0, jc.vocab_size, (b, 1)).astype(np.int32)
             for _ in range(3)]
    ref, jcache = _run_jax(jparams, jc, prompt, steps, max_seq)
    for mode in ("xla", "auto"):
        tcm = dataclasses.replace(tc, kernel_mode=mode)
        got, tcache = _run_port(tparams, tcm, prompt, steps, max_seq)
        if dtype == "float32":
            # [B, S]: position of each slot from which a code differs
            diff = np.zeros((b, max_seq), bool)
            for jcodes, tcodes in ((jcache.k_codes, tcache.k_codes),
                                   (jcache.v_codes, tcache.v_codes)):
                diff |= (jcodes != tcodes.numpy()).any(axis=(0, 2, 4))
            tainted = np.cumsum(diff, axis=1) > 0
        pos0 = 0
        for r, g in zip(ref, got):
            assert r.shape == g.shape
            err = np.max(np.abs(r - g), axis=-1) / np.max(np.abs(r))
            if dtype == "float32":
                tol = np.where(tainted[:, pos0:pos0 + r.shape[1]], 1e-3, 1e-4)
            else:
                tol = 3e-2
            assert np.all(err <= tol), (mode, err)
            pos0 += r.shape[1]
        if dtype != "float32":
            continue
        np.testing.assert_array_equal(tcache.lengths.numpy(),
                                      jcache.lengths)
        for jc_codes, tc_codes in ((jcache.k_codes, tcache.k_codes),
                                   (jcache.v_codes, tcache.v_codes)):
            d = np.abs(jc_codes.astype(np.int32)
                       - tc_codes.numpy().astype(np.int32))
            assert d.max() <= 1
            assert np.mean(d > 0) <= 1e-3, (mode, np.mean(d > 0))
        for js, ts in ((jcache.k_scale, tcache.k_scale),
                       (jcache.v_scale, tcache.v_scale)):
            np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=0)
