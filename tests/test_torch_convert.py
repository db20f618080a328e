"""The port's path from a Hugging Face checkpoint to perplexity, against the
JAX package (CPU).

* ``convert_hf_llama(device="cpu")`` writes ``manifest.json`` and
  ``data.bin`` byte-equal to the JAX ``convert_hf_llama`` on the same
  safetensors directory, one tiny random directory per family: Llama
  untied and Llama tied with llama3 rope (both int4 g64), Llama int8,
  Qwen2 (q/k/v biases), Mixtral, Qwen3-MoE and
  a DeepSeek-V3 toy (``test-tiny-dsv3``'s shapes, the HF model's own random
  init, as ``tests/test_mla.py`` builds it). The JAX reader takes no BF16,
  so a BF16 directory goes through the port and its F32 twin (the same
  values) through JAX.
* The port's safetensors reader equals the ``safetensors`` package on
  F32, F16 (numpy loader) and BF16 tensors (torch loader: numpy has no
  bfloat16).
* ``perplexity`` equals the JAX ``perplexity`` on the same checkpoint
  (test-tiny, float32): |dNLL| <= 1e-4 * NLL.
* A port-converted tiny Llama's forward against transformers'
  ``LlamaForCausalLM`` on the same (dequantized) weights, at the tolerance
  ``tests/test_hf_parity.py`` holds the int8-KV forward to.
* The CLI through ``cli.main`` with ``--device cpu``: ``convert``, ``eval``
  and ``generate``; ``selftest``; QRF1 ``encode`` / ``decode`` /
  ``roundtrip`` files byte-equal with the JAX CLI's ``_qrf1_encode``;
  unported options exit 2 naming the feature. (``convert --codebook``:
  ``tests/test_torch_quant.py``.)

Every JAX conversion runs once per module (``jax_converted``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file as torch_save_file

from quant_tpu import cli as jcli
from quant_tpu.checkpoint import convert_hf_llama as j_convert
from quant_tpu.checkpoint.format import save_checkpoint as j_save
from quant_tpu.eval import perplexity as j_perplexity
from quant_tpu.models import PRESETS as JPRESETS
from quant_tpu.models import llama as jllama
from quant_tpu_torch.checkpoint.format import load_checkpoint as t_load
from quant_tpu_torch.checkpoint.hf import convert_hf_llama as t_convert
from quant_tpu_torch.checkpoint.safetensors import SafetensorsDir
from quant_tpu_torch.cli import main as t_cli
from quant_tpu_torch.eval import perplexity as t_perplexity
from quant_tpu_torch.models import llama as tllama

# transformers, imported by the tests below, would import TensorFlow too
# (about 7 s of set-up under the test run's load); they use only its
# PyTorch models
os.environ.setdefault("USE_TF", "0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ── tiny HF directories ─────────────────────────────────────────────────

TINY = JPRESETS["test-tiny"]          # dim 256, 2 layers, 4/2 heads
MOE = JPRESETS["test-tiny-moe"]       # + 4 experts top-2
DSV3 = JPRESETS["test-tiny-dsv3"]


def _base_config(cfg, model_type: str) -> dict:
    return {"model_type": model_type, "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.dim, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "intermediate_size": cfg.intermediate,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
            "tie_word_embeddings": False}


def _dense_tensors(cfg, rng, kind: str) -> dict:
    """HF-layout float32 tensors ([out, in] linears) of a tiny Llama-family
    model: ``kind`` "llama", "tied" (no lm_head), "qwen2" (q/k/v biases),
    "mixtral" (block_sparse_moe experts w1/w3/w2) or "qwen3_moe" (mlp
    experts, q/k norms)."""
    d, hd, it, v = cfg.dim, cfg.head_dim, cfg.intermediate, cfg.vocab_size

    def w(o, i):
        return rng.standard_normal((o, i)).astype(np.float32) / np.sqrt(i)

    def gain(n):
        return (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    t = {"model.embed_tokens.weight": w(v, d), "model.norm.weight": gain(d)}
    if kind != "tied":
        t["lm_head.weight"] = w(v, d)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        for name, o, k in (("q", cfg.n_heads * hd, d),
                           ("k", cfg.n_kv_heads * hd, d),
                           ("v", cfg.n_kv_heads * hd, d),
                           ("o", d, cfg.n_heads * hd)):
            t[p + f"self_attn.{name}_proj.weight"] = w(o, k)
            if kind == "qwen2" and name != "o":
                t[p + f"self_attn.{name}_proj.bias"] = gain(o) - 1.0
        t[p + "input_layernorm.weight"] = gain(d)
        t[p + "post_attention_layernorm.weight"] = gain(d)
        if kind == "mixtral":
            t[p + "block_sparse_moe.gate.weight"] = w(cfg.n_experts, d)
            for e in range(cfg.n_experts):
                q = p + f"block_sparse_moe.experts.{e}."
                t[q + "w1.weight"] = w(it, d)
                t[q + "w3.weight"] = w(it, d)
                t[q + "w2.weight"] = w(d, it)
        elif kind == "qwen3_moe":
            t[p + "self_attn.q_norm.weight"] = gain(hd)
            t[p + "self_attn.k_norm.weight"] = gain(hd)
            t[p + "mlp.gate.weight"] = w(cfg.n_experts, d)
            for e in range(cfg.n_experts):
                q = p + f"mlp.experts.{e}."
                t[q + "gate_proj.weight"] = w(it, d)
                t[q + "up_proj.weight"] = w(it, d)
                t[q + "down_proj.weight"] = w(d, it)
        else:
            t[p + "mlp.gate_proj.weight"] = w(it, d)
            t[p + "mlp.up_proj.weight"] = w(it, d)
            t[p + "mlp.down_proj.weight"] = w(d, it)
    return t


def _dense_config(cfg, kind: str) -> dict:
    if kind == "tied":
        return {**_base_config(cfg, "llama"), "tie_word_embeddings": True,
                "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                                 "low_freq_factor": 1.0,
                                 "high_freq_factor": 4.0,
                                 "original_max_position_embeddings": 64}}
    if kind == "mixtral":
        return {**_base_config(cfg, "mixtral"),
                "num_local_experts": cfg.n_experts,
                "num_experts_per_tok": cfg.experts_per_token}
    if kind == "qwen3_moe":
        return {**_base_config(cfg, "qwen3_moe"), "head_dim": cfg.head_dim,
                "num_experts": cfg.n_experts,
                "num_experts_per_tok": cfg.experts_per_token,
                "moe_intermediate_size": cfg.intermediate,
                "norm_topk_prob": True}
    return _base_config(cfg, "qwen2" if kind == "qwen2" else "llama")


def _deepseek_dir(path):
    """The DeepSeek-V3 toy: ``DeepseekV3ForCausalLM``'s own random init at
    ``test-tiny-dsv3``'s shapes, written as F32 safetensors."""
    from transformers import DeepseekV3Config, DeepseekV3ForCausalLM

    cfg = DSV3
    torch.manual_seed(0)
    model = DeepseekV3ForCausalLM(DeepseekV3Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
        intermediate_size=cfg.dense_intermediate,
        moe_intermediate_size=cfg.intermediate,
        num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_heads, rms_norm_eps=cfg.norm_eps,
        rope_theta=cfg.rope_theta, tie_word_embeddings=False,
        q_lora_rank=cfg.q_lora_rank, kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_head_dim=cfg.qk_nope_head_dim,
        qk_rope_head_dim=cfg.qk_rope_head_dim, v_head_dim=cfg.v_head_dim,
        n_routed_experts=cfg.n_experts,
        num_experts_per_tok=cfg.experts_per_token,
        n_shared_experts=cfg.n_shared_experts,
        first_k_dense_replace=cfg.first_k_dense,
        n_group=cfg.n_expert_groups, topk_group=cfg.topk_groups,
        routed_scaling_factor=cfg.routed_scaling, norm_topk_prob=True,
        rope_interleave=True, pad_token_id=0))
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()
          if "rotary" not in k}
    # a non-zero selection bias, so its blob is not all zeros
    rng = np.random.default_rng(3)
    for k in sd:
        if k.endswith("e_score_correction_bias"):
            sd[k] = rng.standard_normal(sd[k].shape).astype(np.float32)
    path.mkdir()
    np_save_file(sd, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        **_base_config(cfg, "deepseek_v3"),
        "num_key_value_heads": cfg.n_heads,
        "intermediate_size": cfg.dense_intermediate,
        "moe_intermediate_size": cfg.intermediate,
        "q_lora_rank": cfg.q_lora_rank, "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.qk_nope_head_dim,
        "qk_rope_head_dim": cfg.qk_rope_head_dim,
        "v_head_dim": cfg.v_head_dim, "n_routed_experts": cfg.n_experts,
        "num_experts_per_tok": cfg.experts_per_token,
        "n_shared_experts": cfg.n_shared_experts,
        "first_k_dense_replace": cfg.first_k_dense,
        "n_group": cfg.n_expert_groups, "topk_group": cfg.topk_groups,
        "routed_scaling_factor": cfg.routed_scaling,
        "norm_topk_prob": True, "rope_interleave": True}))


# family -> (model kind, config, bits, group size)
FAMILIES = {
    "llama-int4": ("llama", TINY, 4, 64),
    "llama-tied-llama3-int4": ("tied", TINY, 4, 64),
    "llama-int8": ("llama", TINY, 8, 64),
    "qwen2": ("qwen2", TINY, 4, 64),
    "mixtral": ("mixtral", MOE, 4, 64),
    "qwen3-moe": ("qwen3_moe", MOE, 4, 64),
    "deepseek-v3": ("deepseek_v3", DSV3, 4, 64),
}


@pytest.fixture(scope="module")
def jax_converted(tmp_path_factory):
    """family -> (HF dir, JAX checkpoint dir); one HF directory per kind
    (the int8 family shares llama-int4's), and the BF16 directory of the
    untied Llama with its F32 twin."""
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for fam, (kind, cfg, bits, g) in FAMILIES.items():
        hf = root / kind
        if not hf.exists():
            if kind == "deepseek_v3":
                _deepseek_dir(hf)
            else:
                hf.mkdir()
                rng = np.random.default_rng(len(kind))
                np_save_file(_dense_tensors(cfg, rng, kind),
                             str(hf / "model.safetensors"))
                (hf / "config.json").write_text(
                    json.dumps(_dense_config(cfg, kind)))
        j_convert(hf, root / f"j-{fam}", bits=bits, group_size=g)
        out[fam] = (hf, root / f"j-{fam}")
    # BF16: two files, as HF shards them; the F32 twin holds the same values
    src = np_load_file(str(root / "llama" / "model.safetensors"))
    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in src.items()}
    names = sorted(bf)
    (root / "bf16").mkdir()
    (root / "bf16-f32").mkdir()
    for j, part in enumerate((names[::2], names[1::2])):
        torch_save_file({k: bf[k] for k in part},
                        str(root / "bf16" / f"model-{j}.safetensors"))
        np_save_file({k: bf[k].float().numpy() for k in part},
                     str(root / "bf16-f32" / f"model-{j}.safetensors"))
    for d in ("bf16", "bf16-f32"):
        (root / d / "config.json").write_text(
            (root / "llama" / "config.json").read_text())
    j_convert(root / "bf16-f32", root / "j-bf16", bits=4, group_size=64)
    out["bf16"] = (root / "bf16", root / "j-bf16")
    return out


def _assert_same_files(a, b):
    for name in ("manifest.json", "data.bin"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("fam", list(FAMILIES) + ["bf16"])
def test_convert_byte_equal_to_jax(fam, jax_converted, tmp_path):
    hf, jdir = jax_converted[fam]
    bits, g = (FAMILIES[fam][2:] if fam in FAMILIES else (4, 64))
    cfg = t_convert(hf, tmp_path / "t", bits=bits, group_size=g,
                    device="cpu")
    _assert_same_files(tmp_path / "t", jdir)
    assert cfg.bits == bits and cfg.group_size == g
    params, lcfg = t_load(tmp_path / "t", device="cpu")
    assert lcfg.n_layers == FAMILIES.get(fam, ("", TINY))[1].n_layers
    if fam == "qwen2":   # the q/k/v biases load with the weights
        assert lcfg.qkv_bias and params.layers.qkv_bias.abs().max() > 0


@pytest.mark.parametrize("kw,feature", [
    ({"algo": "gptq", "calib_tokens": np.zeros((1, 8), np.int32)}, "GPTQ"),
    ({"algo": "awq", "calib_tokens": np.zeros((1, 8), np.int32)}, "AWQ"),
    ({"tp": 2}, "tp=2")])
def test_convert_refuses_unported_options(kw, feature, tmp_path):
    with pytest.raises(NotImplementedError, match=feature):
        t_convert(tmp_path / "none", tmp_path / "t", device="cpu", **kw)


# ── safetensors reader ──────────────────────────────────────────────────


def test_safetensors_reader_matches_package(tmp_path):
    rng = np.random.default_rng(0)
    f32 = {"a": rng.standard_normal((3, 5)).astype(np.float32),
           "b": rng.standard_normal((7,)).astype(np.float16),
           "empty": np.zeros((0, 4), np.float32)}
    bf = {"c": torch.from_numpy(rng.standard_normal((4, 6)).astype(
        np.float32)).to(torch.bfloat16)}
    np_save_file(f32, str(tmp_path / "x-0.safetensors"),
                 metadata={"format": "np"})
    torch_save_file(bf, str(tmp_path / "x-1.safetensors"))
    rd = SafetensorsDir(tmp_path)
    assert sorted(rd.keys()) == ["a", "b", "c", "empty"]
    want = np_load_file(str(tmp_path / "x-0.safetensors"))
    for k, v in want.items():
        got = rd.get(k)
        assert got.numpy().dtype == v.dtype and got.shape == v.shape
        np.testing.assert_array_equal(got.numpy(), v)
    got = rd.get("c")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch_load_file(
        str(tmp_path / "x-1.safetensors"))["c"])
    assert "a" in rd and "z" not in rd
    rd.close()


# ── perplexity, HF parity ───────────────────────────────────────────────


def test_perplexity_matches_jax(tmp_path):
    cfg = dataclasses.replace(TINY, dtype="float32")
    jparams = jllama.init_params(cfg, seed=0)
    j_save(tmp_path / "c", jparams, cfg)
    tparams, tcfg = t_load(tmp_path / "c", device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, 3 * 32 + 5)
    want = j_perplexity(jparams, cfg, toks, window=32, limit_windows=3)
    got = t_perplexity(tparams, tcfg, toks, window=32, limit_windows=3)
    assert got["tokens"] == want["tokens"] == 96
    assert abs(got["nll"] - want["nll"]) <= 1e-4 * want["nll"]
    assert abs(got["ppl"] - want["ppl"]) <= 1e-3 * want["ppl"]


def test_converted_llama_matches_transformers(tmp_path):
    """transformers' LlamaForCausalLM on int8-g64 dequantized random weights
    (a bf16-representable embedding: the converter stores it in bf16), the
    same weights through ``convert`` and the port's forward (float32, int8
    KV): the tolerance of ``test_hf_parity.test_logits_match_transformers``
    (int8-KV noise): rtol 0.1, atol 0.15, argmax agreement >= 0.85,
    correlation > 0.999."""
    from transformers import LlamaConfig, LlamaForCausalLM

    from quant_tpu_torch.core.qtensor import quantize_tensor

    cfg = TINY
    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
        intermediate_size=cfg.intermediate, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
        rms_norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta,
        tie_word_embeddings=False, attention_bias=False))
    model.eval()
    sd = {}
    for k, v in model.state_dict().items():
        v = v.detach().float()
        if k == "model.embed_tokens.weight":
            v = v.to(torch.bfloat16).float()
        elif v.dim() == 2:      # [out, in]: quantize along in, dequantize
            v = quantize_tensor(v.T.numpy(), 8, 64).dequantize().T
        sd[k] = v.contiguous()
    model.load_state_dict(sd)
    hf = tmp_path / "hf"
    hf.mkdir()
    torch_save_file(sd, str(hf / "model.safetensors"))
    (hf / "config.json").write_text(json.dumps(_base_config(cfg, "llama")))
    t_convert(hf, tmp_path / "c", bits=8, group_size=64, device="cpu")
    params, lcfg = t_load(tmp_path / "c", device="cpu")
    lcfg = dataclasses.replace(lcfg, dtype="float32")
    toks = np.random.default_rng(0).integers(2, cfg.vocab_size, (2, 7))
    with torch.no_grad():
        want = model(torch.from_numpy(toks)).logits.numpy()
        got, _ = tllama.forward(params, torch.from_numpy(toks),
                                tllama.init_cache(lcfg, 2, 16, "cpu"), lcfg,
                                device="cpu")
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0.1, atol=0.15)
    assert np.mean(np.argmax(got, -1) == np.argmax(want, -1)) >= 0.85
    assert np.corrcoef(got.reshape(-1), want.reshape(-1))[0, 1] > 0.999


# ── CLI ─────────────────────────────────────────────────────────────────


def _json_lines(capsys) -> list:
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()]


def test_cli_convert_eval_generate(jax_converted, tmp_path, capsys):
    hf, _ = jax_converted["llama-int4"]
    ck = tmp_path / "ckpt"
    assert t_cli(["convert", str(hf), str(ck), "--bits", "4",
                  "--group-size", "64", "--device", "cpu"]) == 0
    (conv,) = _json_lines(capsys)
    assert conv["coder"] in ("c++", "python") and conv["config"]["bits"] == 4
    text = tmp_path / "text.txt"
    text.write_text("The quick brown fox jumps over the lazy dog. " * 4)
    assert t_cli(["eval", str(ck), "--text", str(text), "--window", "32",
                  "--limit-windows", "2", "--device", "cpu"]) == 0
    (ev,) = _json_lines(capsys)
    params, cfg = t_load(ck, device="cpu")
    ids = np.frombuffer(text.read_bytes(), np.uint8).astype(np.int32)
    want = t_perplexity(params, cfg, ids, window=32, limit_windows=2)
    assert ev["tokens"] == 64 and ev["nll"] == pytest.approx(want["nll"])
    assert t_cli(["generate", str(ck), "--prompt-ids", "1,2,3;4,5",
                  "--max-new", "3", "--eos-id", "-1", "--device",
                  "cpu"]) == 0
    outs = _json_lines(capsys)
    assert [len(x["output"]) for x in outs] == [3, 3]


def test_cli_selftest(capsys):
    assert t_cli(["selftest", "--device", "cpu"]) == 0
    lines = _json_lines(capsys)
    assert lines[-1]["ok"] and lines[-1]["e2e_generate"]
    assert lines[0] == {"oracle": False} or lines[0]["codes_bit_exact"]


@pytest.mark.parametrize("bits", [4, 8])
def test_cli_qrf1_matches_jax(bits, tmp_path, capsys):
    x = np.random.default_rng(bits).standard_normal(5001).astype(np.float32)
    src = tmp_path / "x.npy"
    np.save(src, x)
    assert t_cli(["encode", str(src), str(tmp_path / "t.qrf"), "--bits",
                  str(bits)]) == 0
    blob = (tmp_path / "t.qrf").read_bytes()
    assert blob == jcli._qrf1_encode(x, bits)
    assert t_cli(["decode", str(tmp_path / "t.qrf"),
                  str(tmp_path / "t.f32")]) == 0
    np.testing.assert_array_equal(
        np.fromfile(tmp_path / "t.f32", np.float32),
        jcli._qrf1_decode(blob)[0].astype(np.float32))
    capsys.readouterr()
    assert t_cli(["roundtrip", str(src), "--bits", str(bits)]) == 0
    rt = _json_lines(capsys)[-1]
    assert rt["ok"] and rt["n"] == 5001


@pytest.mark.parametrize("argv,feature", [
    (["convert", "hf", "out", "--algo", "gptq", "--device", "cpu"], "GPTQ"),
    (["convert", "hf", "out", "--algo", "awq+gptq", "--device", "cpu"],
     "GPTQ/AWQ"),
    (["convert", "hf", "out", "--tp", "2", "--device", "cpu"], "tp=2"),
    (["convert", "hf", "out", "--algo", "awq", "--device", "cpu"], "AWQ"),
    (["bench"], "bench")])
def test_cli_unported_exits_2(argv, feature, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert t_cli(argv) == 2
    err = capsys.readouterr().err
    assert "not ported" in err and feature in err

