"""Codebook weights and int8 activations in the port, against the JAX
package (CPU).

* The oracle binding's codebook functions (``nf4_table``,
  ``quantize_lut*``, ``dequantize_lut``) against the port's codec: equal.
* ``quantize_tensor`` and ``quantize_tensor_device`` with ``codebook=``
  (nf4, lloyd, an explicit table) against JAX ``quantize_tensor``: codes,
  scales and table equal; ``transcode_lut_int8`` against JAX's, equal, a
  stack with per-layer tables too.
* The plain ``dequant_matmul`` (the CPU path of the wrapper) at word4,
  sel15 and ``act_quant`` (4 and 8 bits) against JAX ``dequant_matmul(...,
  interpret=True)`` on the same inputs, float32 x at M <= 64 (the Pallas
  body's float32 compute): within 2e-6 of max|ref| (the two sum the
  groups' partial products in another order); a stack with an nf4 and a
  lloyd table indexed by layer.
* ``test-tiny`` float32 forwards (one prefill chunk, three decode steps)
  at word4 (JAX ``pallas_interpret``), sel15, lloyd, the int8 transcode,
  W4A8 and W8A8 (JAX ``xla``) against JAX: logits within 1e-4 of
  max|logit|, a KV code off by one at a rounding tie allowed as in
  ``tests/test_torch_llama.py`` (1e-3 after it), and, at W4A8 / W8A8, an
  activation code that differs from JAX's (a rounding tie of its int8
  grid, which the two frameworks' last-ulp differences in x decide either
  way; each package's x is read at every act_quant matmul) allowed one
  int8 step of x from its position on in its slot (1e-2; W8A8 measured
  3.1e-3 at the one such position, every other within 1e-6); the port's
  nf4 forward
  nearer than linear int4 to the float32 model (the JAX test
  ``test_codebook_forward_beats_linear_int4``).
* Codebook checkpoints (nf4; lloyd, one table per layer) written by JAX
  load in the port at each ``lut_runtime`` with JAX's leaves, and the
  port's write loads in JAX with the same leaves.
* ``convert --codebook`` (nf4, lloyd) of a transformers ``LlamaForCausalLM``
  directory byte-equal to the JAX converter's, then ``eval --lut-runtime
  sel15`` and ``generate --lut-runtime word4`` through the CLI.

Every JAX run is module-scoped and shared.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.checkpoint import convert_hf_llama as j_convert
from quant_tpu.checkpoint.format import _flatten_params
from quant_tpu.checkpoint.format import load_checkpoint as j_load
from quant_tpu.checkpoint.format import save_checkpoint as j_save
from quant_tpu.core import qtensor as jq
from quant_tpu.kernels.dequant_matmul import dequant_matmul as j_dmm
from quant_tpu.models import PRESETS as JPRESETS
from quant_tpu.models import llama as jllama
from quant_tpu_torch.checkpoint.format import load_checkpoint as t_load
from quant_tpu_torch.checkpoint.format import save_checkpoint as t_save
from quant_tpu_torch.checkpoint.hf import convert_hf_llama as t_convert
from quant_tpu_torch.cli import main as t_cli
from quant_tpu_torch.core import codec, oracle
from quant_tpu_torch.core import qtensor as tq
from quant_tpu_torch.engine import Engine as TEngine
from quant_tpu_torch.kernels import dequant_matmul as dmm_mod
from quant_tpu_torch.kernels.dequant_matmul import dequant_matmul as t_dmm
from quant_tpu_torch.models import llama as tllama
from quant_tpu_torch.models.config import ModelConfig as TConfig
from quant_tpu_torch.models.transfer import flat_from_params, params_from_flat

os.environ.setdefault("USE_TF", "0")

_jit_forward = jax.jit(jllama.forward, static_argnames=("cfg",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_qt(a, b, what):
    for f in ("codes", "scales", "lut"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), (what, f)
        if x is not None:
            np.testing.assert_array_equal(_np(x), _np(y), err_msg=f"{what} {f}")
    assert (a.bits, a.group_size, tuple(a.shape)) == (
        b.bits, b.group_size, tuple(b.shape)), what


# ── codec and oracle ─────────────────────────────────────────────────────


def test_oracle_codebook_matches_codec():
    assert oracle.available()
    np.testing.assert_array_equal(oracle.nf4_table(), codec.NF4_TABLE)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 256)).astype(np.float32)
    x[1, :64] = 0.0                                   # an all-zero group
    lut = codec.lloyd_max_fit(x)
    for table in (codec.NF4_TABLE, lut):
        c, s = oracle.quantize_lut_grouped(x, table, 64)
        c2, s2 = codec.quantize_lut(x, table, 64)
        np.testing.assert_array_equal(c, c2)
        np.testing.assert_array_equal(s, s2)
        c1, s1 = oracle.quantize_lut(x, table)
        c3, s3 = codec.quantize_lut(x, table)
        np.testing.assert_array_equal(c1, c3.reshape(-1))
        assert s1 == float(s3)
        np.testing.assert_array_equal(
            oracle.dequantize_lut(c[2, :64], table, float(s[2, 0])),
            codec.dequantize_lut(c[2, :64], s[2, 0], table))


@pytest.mark.parametrize("cb", ["nf4", "lloyd", "table"])
def test_quantize_tensor_codebook_matches_jax(cb):
    """Host and device quantizers against JAX's host quantizer: every field
    equal; the device form counts the same float32 midpoints (lloyd: the
    table fitted on the host is handed to it)."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((256, 96)).astype(np.float32)
    w[:64, 5] = 0.0
    spec = (np.sort(rng.uniform(-1, 1, 16)).astype(np.float32)
            if cb == "table" else cb)
    want = jq.quantize_tensor(w, 4, 64, codebook=spec)
    _same_qt(tq.quantize_tensor(w, 4, 64, codebook=spec), want, cb)
    table = np.asarray(want.lut) if cb == "lloyd" else spec
    _same_qt(tq.quantize_tensor_device(torch.from_numpy(w), 4, 64,
                                       codebook=table), want, cb)
    if cb == "lloyd":
        with pytest.raises(ValueError, match="host-only"):
            tq.quantize_tensor_device(torch.from_numpy(w), 4, 64,
                                      codebook="lloyd")


def _stack2(k=256, n=128, g=64, seed=5):
    """Two layers with different tables (nf4, then a lloyd fit to a weight
    of twice the spread): (JAX stacked QTensor, port stacked QTensor, the
    JAX per-layer QTensors)."""
    rng = np.random.default_rng(seed)
    qts = []
    for i in range(2):
        w = rng.standard_normal((k, n)).astype(np.float32) * (i + 1)
        qts.append(jq.quantize_tensor(
            w, 4, g, codebook=codec.lloyd_max_fit(w) if i else "nf4"))
    js = jax.tree.map(lambda *xs: jnp.stack(xs), *qts)
    ts = tq.QTensor(codes=torch.from_numpy(np.array(js.codes)),
                    scales=torch.from_numpy(np.array(js.scales)), bits=4,
                    group_size=g, shape=(k, n),
                    lut=torch.from_numpy(np.array(js.lut)))
    return js, ts, qts


def test_transcode_lut_int8_matches_jax():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    one = jq.quantize_tensor(w, 4, 32, codebook="nf4")
    tone = tq.quantize_tensor(w, 4, 32, codebook="nf4")
    _same_qt(tq.transcode_lut_int8(tone), jq.transcode_lut_int8(one), "flat")
    js, ts, _ = _stack2()
    _same_qt(tq.transcode_lut_int8(ts), jq.transcode_lut_int8(js),
             "stacked")
    lin = tq.quantize_tensor(w, 4, 32)
    assert tq.transcode_lut_int8(lin) is lin


# ── the plain matmul against the Pallas kernel (interpret mode) ─────────


def _x(m, k, seed):
    return np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_dmm():
    """{case: (x, JAX QTensor, Pallas output)} for one JAX run each."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((512, 256)).astype(np.float32)
    lut_qt = jq.quantize_tensor(w, 4, 128, codebook="nf4")
    out = {}
    for case, qt, kw in (
            ("word4", lut_qt, {}),
            ("sel15", lut_qt, {"lut_exact": True}),
            ("aq4", jq.quantize_tensor(w, 4, 128), {"act_quant": True}),
            ("aq8", jq.quantize_tensor(w, 8, 128), {"act_quant": True})):
        x = _x(8, 512, len(case))
        y = j_dmm(jnp.asarray(x), qt, tile_n=128, tile_k=128,
                  interpret=True, **kw)
        out[case] = (x, qt, np.asarray(y))
    js, _, _ = _stack2()
    x = _x(16, 256, 9)
    out["stacked"] = (x, js, [np.asarray(j_dmm(
        jnp.asarray(x), js, jnp.int32(i), tile_n=128, tile_k=128,
        interpret=True)) for i in range(2)])
    return out


def _port_qt(jqt) -> tq.QTensor:
    return tq.QTensor(codes=torch.from_numpy(np.array(jqt.codes)),
                      scales=torch.from_numpy(np.array(jqt.scales)),
                      bits=jqt.bits, group_size=jqt.group_size,
                      shape=tuple(jqt.shape),
                      lut=None if jqt.lut is None else torch.from_numpy(
                          np.array(jqt.lut)))


@pytest.mark.parametrize("case", ["word4", "sel15", "aq4", "aq8"])
def test_plain_matmul_matches_pallas(jax_dmm, case):
    x, jqt, ref = jax_dmm[case]
    got = t_dmm(torch.from_numpy(x), _port_qt(jqt),
                lut_exact=case == "sel15",
                act_quant=case.startswith("aq")).numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 2e-6, (case, err)


def test_plain_matmul_takes_each_layers_table(jax_dmm):
    """The stack's second layer has another table: a wrong table index is
    off by far more than the tolerance (checked on the JAX outputs)."""
    x, _, refs = jax_dmm["stacked"]
    _, ts, _ = _stack2()
    assert np.abs(refs[0] - refs[1]).max() > 0.1 * np.abs(refs[1]).max()
    for i, ref in enumerate(refs):
        got = t_dmm(torch.from_numpy(x), ts, i).numpy()
        assert np.abs(got - ref).max() <= 2e-6 * np.abs(ref).max(), i


# ── forward ──────────────────────────────────────────────────────────────

_B, _MAX_SEQ = 2, 32
# variant -> (JAX config change, JAX kernel_mode, lut transcode)
_VARIANTS = {
    "word4": ({"codebook": "nf4", "lut_runtime": "word4"},
              "pallas_interpret", False),
    "sel15": ({"codebook": "nf4", "lut_runtime": "sel15"}, "xla", False),
    "lloyd": ({"codebook": "lloyd", "lut_runtime": "sel15"}, "xla", False),
    "int8": ({"codebook": "nf4"}, "xla", True),
    "w4a8": ({"act_quant": True}, "xla", False),
    "w8a8": ({"act_quant": True, "bits": 8}, "xla", False),
}


def _cfg(change, mode="xla"):
    jc = dataclasses.replace(JPRESETS["test-tiny"], dtype="float32",
                             kernel_mode=mode, attn_kernel="xla", **change)
    return jc, TConfig(**dataclasses.asdict(jc))


def _toks():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 512, (_B, 12)).astype(np.int32)] + [
        rng.integers(0, 512, (_B, 1)).astype(np.int32) for _ in range(3)]


@pytest.fixture(scope="module")
def jax_forwards():
    """variant -> (flat params for the port, logits per call, K codes, the
    x of every act_quant matmul in call order, through a host callback in
    the jitted forward)."""
    out = {}
    real = jllama.dequant_matmul_reference
    for name, (change, mode, transcode) in _VARIANTS.items():
        jc, _ = _cfg(change, mode)
        jp = jllama.init_params(jc, seed=3)
        if transcode:
            jp = jax.tree.map(
                lambda q: jq.transcode_lut_int8(q)
                if isinstance(q, jq.QTensor) else q, jp,
                is_leaf=lambda q: isinstance(q, jq.QTensor))
        xs = []

        def watched(x, qt, out_dtype=None, act_quant=False):
            if act_quant:
                jax.debug.callback(lambda v: xs.append(np.asarray(v)), x,
                                   ordered=True)
            return real(x, qt, out_dtype, act_quant=act_quant)

        jllama.dequant_matmul_reference = watched
        try:
            cache = jllama.init_cache(jc, _B, _MAX_SEQ)
            outs = []
            for x in _toks():
                lg, cache = _jit_forward(jp, jnp.asarray(x), cache, cfg=jc)
                outs.append(np.asarray(lg, np.float32))
        finally:
            jllama.dequant_matmul_reference = real
        out[name] = (_flatten_params(jax.tree.map(np.asarray, jp)), outs,
                     np.asarray(cache.k_codes), xs)
    return out


def _codes(x: np.ndarray, g: int) -> np.ndarray:
    """The int8 grid both packages put activations on (per row and group:
    scale absmax / 127, round half to even), in numpy."""
    xg = x.reshape(x.shape[0], -1, g).astype(np.float32)
    sx = np.max(np.abs(xg), axis=-1, keepdims=True) / np.float32(127.0)
    sx = np.where(sx == 0, np.float32(1.0), sx)
    return np.round(xg / sx).reshape(x.shape)


def _port_logits(flat, tc, device="cpu", seen=None):
    """Logits per call and the cache; ``seen`` collects the x of every
    ``act_quant`` matmul, [B*T, K], in call order."""
    params = params_from_flat(flat, tc, device)
    cache = tllama.init_cache(tc, _B, _MAX_SEQ, device)
    outs = []
    real = dmm_mod.act_quant_int8_reference

    def watched(x, g):
        seen.append(x.float().numpy().copy())
        return real(x, g)

    if seen is not None:
        dmm_mod.act_quant_int8_reference = watched
    try:
        for x in _toks():
            lg, cache = tllama.forward(params, torch.from_numpy(x), cache,
                                       tc, device=device)
            outs.append(lg.float().numpy())
    finally:
        dmm_mod.act_quant_int8_reference = real
    return outs, cache


def _aq_flips(j_xs, t_xs, g) -> np.ndarray:
    """[B, S]: positions whose activations sit on another int8 code in the
    two packages (a rounding tie that their last-ulp differences in x
    decide either way)."""
    assert len(j_xs) == len(t_xs)
    flips = np.zeros((_B, _MAX_SEQ), bool)
    lens = [x.shape[1] for x in _toks()]
    per = len(j_xs) // len(lens)                  # matmuls per forward
    for i, (jx, tx) in enumerate(zip(j_xs, t_xs)):
        jx = jx.reshape(-1, jx.shape[-1])
        t, p0 = lens[i // per], sum(lens[:i // per])
        assert jx.shape == tx.shape == (_B * t, jx.shape[1])
        bad = (_codes(jx, g) != _codes(tx, g)).any(-1).reshape(_B, t)
        flips[:, p0:p0 + t] |= bad
    return flips


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_tiny_forward_matches_jax(jax_forwards, variant):
    flat, ref, j_codes, j_xs = jax_forwards[variant]
    change, _, _ = _VARIANTS[variant]
    _, tc = _cfg(change, "auto")
    if variant == "int8":
        flat = {k: tq.transcode_lut_int8(v) if isinstance(v, tq.QTensor)
                else v for k, v in flat.items()}
        assert "lut" not in repr(flat["lm_head"].lut)
    else:
        # the port's QTensors carry the tables (word4 / sel15) or none
        assert (flat["lm_head"].lut is not None) == ("codebook" in change)
    t_xs = []
    got, cache = _port_logits(flat, tc, seen=t_xs)
    # positions from a slot's first K code that differs: one step at a tie
    diff = (cache.k_codes.numpy() != j_codes).any(axis=(0, 2, 4))
    assert diff.mean() <= 0.1
    tainted = np.cumsum(diff, axis=1) > 0
    # from an activation code that differs on: one int8 step of x
    flips = _aq_flips(j_xs, t_xs, tc.group_size)
    assert flips.mean() <= 0.1 and (bool(t_xs) == tc.act_quant)
    aq_tainted = np.cumsum(flips, axis=1) > 0
    pos0 = 0
    for r, g in zip(ref, got):
        assert r.shape == g.shape and np.isfinite(g).all()
        err = np.max(np.abs(r - g), axis=-1) / np.max(np.abs(r))
        sl = slice(pos0, pos0 + r.shape[1])
        tol = np.where(aq_tainted[:, sl], 1e-2,
                       np.where(tainted[:, sl], 1e-3, 1e-4))
        assert np.all(err <= tol), (variant, err)
        pos0 += r.shape[1]


def test_nf4_forward_beats_linear_int4():
    """NF4 bins suit Gaussian weights: from the same dense weights (JAX
    ``init_params``, seed 4), the port's nf4 model tracks the float32
    reference (8-bit weights) closer than linear int4, in logits MSE."""
    toks = np.asarray([[3, 1, 4, 1, 5, 9, 2, 6]], np.int32)

    def logits(change):
        jc, tc = _cfg(change)
        tc = dataclasses.replace(tc, kernel_mode="auto")
        params = params_from_flat(_flatten_params(jax.tree.map(
            np.asarray, jllama.init_params(jc, seed=4))), tc, "cpu")
        lg, _ = tllama.forward(params, torch.from_numpy(toks),
                               tllama.init_cache(tc, 1, 16, "cpu"), tc,
                               device="cpu")
        return lg.numpy()

    ref = logits({"bits": 8})
    lin = float(np.mean((logits({}) - ref) ** 2))
    nf4 = float(np.mean((logits({"codebook": "nf4",
                                 "lut_runtime": "sel15"}) - ref) ** 2))
    assert nf4 < lin, (nf4, lin)


# ── checkpoints ──────────────────────────────────────────────────────────


def _leaves(flat):
    return {k: v for k, v in flat.items()}


def _assert_same_leaves(a: dict, b: dict, what):
    assert a.keys() == b.keys(), what
    for k in a:
        x, y = a[k], b[k]
        if hasattr(x, "codes") and hasattr(x, "bits"):
            _same_qt(x, y, f"{what} {k}")
        elif hasattr(x, "codes"):
            np.testing.assert_array_equal(_np(x.codes), _np(y.codes))
        else:
            np.testing.assert_array_equal(_np(x), _np(y), err_msg=k)


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """codebook -> (JAX checkpoint dir, JAX-loaded flat leaves per
    lut_runtime)."""
    root = tmp_path_factory.mktemp("ck")
    out = {}
    for cb in ("nf4", "lloyd"):
        jc, _ = _cfg({"codebook": cb})
        j_save(root / cb, jllama.init_params(jc, seed=5), jc)
        loaded = {}
        for rt in ("int8", "word4", "sel15"):
            jp, _ = j_load(root / cb, lut_runtime=rt)
            loaded[rt] = _flatten_params(jax.tree.map(np.asarray, jp))
        out[cb] = (root / cb, loaded)
    return out


@pytest.mark.parametrize("cb", ["nf4", "lloyd"])
def test_codebook_checkpoints_cross_load(jax_ckpts, cb, tmp_path):
    path, loaded = jax_ckpts[cb]
    for rt in ("int8", "word4", "sel15"):
        params, cfg = t_load(path, device="cpu", lut_runtime=rt)
        assert cfg.lut_runtime == rt and cfg.codebook == cb
        flat = flat_from_params(params)
        _assert_same_leaves(flat, loaded[rt], (cb, rt))
        if rt == "sel15":
            luts = params.layers.wqkv.lut
            assert luts.shape == (2, 16)
            assert (cb == "lloyd") == bool((luts[0] != luts[1]).any())
            t_save(tmp_path / "t", params, cfg)
    jp, _ = j_load(tmp_path / "t", lut_runtime="sel15")
    _assert_same_leaves(_flatten_params(jax.tree.map(np.asarray, jp)),
                        loaded["sel15"], (cb, "port-written"))


# ── convert --codebook ───────────────────────────────────────────────────


@pytest.fixture(scope="module")
def hf_tiny(tmp_path_factory):
    """A transformers ``LlamaForCausalLM`` at test-tiny's shapes, its own
    random init, saved as safetensors; JAX conversions nf4 and lloyd."""
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = JPRESETS["test-tiny"]
    root = tmp_path_factory.mktemp("hf")
    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
        intermediate_size=cfg.intermediate, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
        rms_norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta,
        tie_word_embeddings=False))
    model.save_pretrained(root / "hf", safe_serialization=True)
    for cb in ("nf4", "lloyd"):
        j_convert(root / "hf", root / f"j-{cb}", bits=4, group_size=64,
                  codebook=cb)
    return root


@pytest.mark.parametrize("cb", ["nf4", "lloyd"])
def test_convert_codebook_matches_jax(hf_tiny, cb, tmp_path, capsys):
    """``cli convert --codebook`` byte-equal to the JAX converter; then
    ``eval --lut-runtime sel15`` equals the plain forward's NLL on the
    exact tables and ``generate --lut-runtime word4`` the word4 engine's
    greedy streams."""
    out = tmp_path / "t"
    assert t_cli(["convert", str(hf_tiny / "hf"), str(out), "--bits", "4",
                  "--group-size", "64", "--codebook", cb,
                  "--device", "cpu"]) == 0
    for name in ("manifest.json", "data.bin"):
        assert (out / name).read_bytes() == (
            hf_tiny / f"j-{cb}" / name).read_bytes(), (cb, name)
    capsys.readouterr()
    text = tmp_path / "text.txt"
    text.write_text("The quick brown fox jumps over the lazy dog. " * 3)
    assert t_cli(["eval", str(out), "--text", str(text), "--window", "32",
                  "--limit-windows", "2", "--lut-runtime", "sel15",
                  "--device", "cpu"]) == 0
    ev = json.loads(capsys.readouterr().out.splitlines()[-1])
    params, cfg = t_load(out, device="cpu", lut_runtime="sel15")
    from quant_tpu_torch.eval import perplexity
    ids = torch.from_numpy(np.frombuffer(text.read_bytes(), np.uint8).astype(
        np.int32))
    want = perplexity(params, dataclasses.replace(cfg, kernel_mode="xla"),
                      ids, window=32, limit_windows=2)
    assert ev["tokens"] == want["tokens"] == 64
    assert abs(ev["nll"] - want["nll"]) <= 1e-4 * abs(want["nll"])
    assert t_cli(["generate", str(out), "--prompt-ids", "1,2,3;4,5",
                  "--max-new", "3", "--eos-id", "-1", "--lut-runtime",
                  "word4", "--device", "cpu"]) == 0
    outs = [json.loads(x)["output"]
            for x in capsys.readouterr().out.splitlines()]
    params, cfg = t_load(out, device="cpu", lut_runtime="word4")
    assert params.lm_head.lut is not None
    eng = TEngine(params, cfg, max_slots=8, max_seq=1024, eos_id=-1,
                  device="cpu")
    assert outs == eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=3)
