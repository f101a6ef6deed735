"""The port's model presets, `ModelConfig.from_hf_config`, the HF state-dict
loader and the `.npz` checkpoint loader against the JAX package's, and the
K=0 port engine at head dim 128 against a random-weight `transformers`
Llama (no download: the model is built from its config).

Tolerances: presets, configs and loaded weights exactly (the same float32
values cast to the same dtype); quantized loads exactly against the JAX
package's eager quantizers on the same weights. RoPE caches the `.npz`
loader computes anew 1e-4, as `tests/test_torch_ops.py` holds the port's
RoPE to JAX's (the two frameworks' float32 cos and sin differ in the last
bits); caches it reads from the file exactly. HF logit parity 2e-3 and 8
greedy tokens exactly, as `tests/test_engine.py` holds the JAX engine.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicpig_tpu import config as jcfg
from magicpig_tpu.models import llama as jllama
from magicpig_tpu.models.loader import params_from_state_dict as j_from_state_dict
from magicpig_tpu_torch import config as tcfg
from magicpig_tpu_torch.config import LSHConfig, ModelConfig
from magicpig_tpu_torch.models.convert import NPZ_LEAVES, load_params
from magicpig_tpu_torch.models.loader import params_from_state_dict
from magicpig_tpu_torch.runtime.engine import LLM

ROOT = Path(__file__).resolve().parents[1]
NEEDLE = ROOT / "data" / "needle_ckpt.npz"
F32 = 1e-4
LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fields(cfg) -> dict:
    """The port's ModelConfig fields of a config (either package's), dtype
    aside."""
    return {f.name: dataclasses.asdict(getattr(cfg, f.name))
            if dataclasses.is_dataclass(getattr(cfg, f.name))
            else getattr(cfg, f.name)
            for f in dataclasses.fields(ModelConfig) if f.name != "dtype"}


# -- presets and HF configs ----------------------------------------------------


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_preset_matches_jax(name):
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    jp = jcfg.preset(name)
    assert jp.sliding_window is None
    assert _fields(tcfg.preset(name)) == _fields(jp)


HF_DICTS = {
    "llama3_rope_type": dict(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        rms_norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=131072,
        tie_word_embeddings=False, eos_token_id=[128001, 128008, 128009],
        rope_scaling=dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                          high_freq_factor=4.0,
                          original_max_position_embeddings=8192)),
    "older_type_key": dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
        head_dim=128, eos_token_id=2,
        rope_scaling=dict(type="linear", factor=2.0)),
    "no_head_dim_no_kv_heads": dict(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=2, eos_token_id=[0, 7],
        rope_scaling=None, sliding_window=None),
    "defaults_only": dict(
        vocab_size=1000, hidden_size=384, intermediate_size=1024,
        num_hidden_layers=3, num_attention_heads=6, num_key_value_heads=2),
    # huggingface.co/mistralai/Mistral-7B-v0.1, config.json: the sliding
    # window.
    "mistral_v01": dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=32768,
        sliding_window=4096, tie_word_embeddings=False, bos_token_id=1,
        eos_token_id=2),
    # huggingface.co/HuggingFaceTB/SmolLM2-360M, config.json: 15 query heads
    # over 5 of 64 (group size 3 at head dim 64), tied embeddings.
    "smollm2_360m": dict(
        vocab_size=49152, hidden_size=960, intermediate_size=2560,
        num_hidden_layers=32, num_attention_heads=15, num_key_value_heads=5,
        rms_norm_eps=1e-5, rope_theta=100000, rope_scaling=None,
        max_position_embeddings=8192, tie_word_embeddings=True,
        bos_token_id=0, eos_token_id=0),
    # huggingface.co/meta-llama/Llama-3.1-405B, config.json: 128 query
    # heads over 8 of 128 (group size 16).
    "llama_31_405b": dict(
        vocab_size=128256, hidden_size=16384, intermediate_size=53248,
        num_hidden_layers=126, num_attention_heads=128, num_key_value_heads=8,
        rms_norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=131072,
        tie_word_embeddings=False, bos_token_id=128000, eos_token_id=128001,
        rope_scaling=dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                          high_freq_factor=4.0,
                          original_max_position_embeddings=8192)),
}


@pytest.mark.parametrize("case", sorted(HF_DICTS))
def test_from_hf_config_matches_jax(case):
    cfg = HF_DICTS[case]
    got = ModelConfig.from_hf_config(cfg, name=case)
    want = jcfg.ModelConfig.from_hf_config(cfg, name=case)
    assert want.sliding_window == cfg.get("sliding_window")
    assert _fields(got) == _fields(want)
    assert ModelConfig.from_hf_config(cfg).name == "hf-model"


def test_from_hf_config_reads_a_config_json(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(HF_DICTS["llama3_rope_type"]))
    got = ModelConfig.from_hf_config(path, name="8b")
    want = jcfg.ModelConfig.from_hf_config(str(path), name="8b")
    assert _fields(got) == _fields(want)
    assert _fields(got) == _fields(dataclasses.replace(
        tcfg.preset("llama-3.1-8b"), name="8b"))


# -- the HF state-dict loader --------------------------------------------------

HF_TINY = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=1, head_dim=128, rms_norm_eps=1e-5,
               rope_theta=10000.0, max_position_embeddings=1024)


def _hf_model(tie: bool):
    """A random-weight HF Llama at head dim 128, group 4, float32."""
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM

    hf_cfg = HFConfig(**HF_TINY, attention_bias=False, mlp_bias=False,
                      tie_word_embeddings=tie)
    torch.manual_seed(0)
    return LlamaForCausalLM(hf_cfg).eval()


@pytest.fixture(scope="module")
def hf_untied():
    return _hf_model(tie=False)


def _tiny_configs(tie: bool, weight_quant: str = "none"):
    cfg = dict(HF_TINY, tie_word_embeddings=tie, eos_token_id=0)
    j = dataclasses.replace(jcfg.ModelConfig.from_hf_config(cfg, name="t"),
                            dtype=jnp.float32)
    t = dataclasses.replace(ModelConfig.from_hf_config(cfg, name="t"),
                            dtype=torch.float32, weight_quant=weight_quant,
                            fuse_small_linears=weight_quant != "none")
    return j, t


def _assert_same_params(tp, jp, rope_tol=None):
    for name in LAYER_WEIGHTS + ("ln_attn", "ln_mlp"):
        np.testing.assert_array_equal(_np(getattr(tp.layers, name)),
                                      np.asarray(getattr(jp.layers, name)))
    for name in ("embed", "lm_head", "final_ln"):
        np.testing.assert_array_equal(_np(getattr(tp, name)),
                                      np.asarray(getattr(jp, name)))
    for name in ("cos", "sin"):
        got, want = _np(getattr(tp, name)), np.asarray(getattr(jp, name))
        if rope_tol is None:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=rope_tol, rtol=rope_tol)


@pytest.mark.parametrize("tie", [False, True])
def test_params_from_state_dict_matches_jax(tie, hf_untied):
    model = hf_untied if not tie else _hf_model(tie=True)
    sd = model.state_dict()
    assert ("lm_head.weight" in sd) and (
        not tie or sd["lm_head.weight"].data_ptr()
        == sd["model.embed_tokens.weight"].data_ptr())
    jc, tc = _tiny_configs(tie)
    jp = j_from_state_dict(jc, sd, 64, dtype=jnp.float32)
    tp = params_from_state_dict(tc, sd, 64, device="cpu")
    _assert_same_params(tp, jp, rope_tol=F32)
    assert tp.layers.wq.dtype == torch.float32 and tp.layers.wq.is_contiguous()
    if not tie:       # HF's own lm_head, transposed, not embed.T
        assert not np.array_equal(_np(tp.lm_head), _np(tp.embed).T)
    # bf16 by default, cast from float32 as the JAX loader casts.
    jb = j_from_state_dict(dataclasses.replace(jc, dtype=jnp.bfloat16), sd, 64)
    tb = params_from_state_dict(dataclasses.replace(tc, dtype=torch.bfloat16),
                                sd, 64, device="cpu")
    assert tb.layers.w_down.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tb.layers.w_down.float()),
                                  np.asarray(jb.layers.w_down, np.float32))
    np.testing.assert_array_equal(_np(tb.lm_head.float()),
                                  np.asarray(jb.lm_head, np.float32))


@pytest.mark.parametrize("weight_quant", ["int8", "int4"])
def test_params_from_state_dict_quantizes_and_fuses(weight_quant, hf_untied):
    """The quantized branch: every weight of the loaded params quantized as
    the JAX package's eager quantizer quantizes the JAX loader's weights,
    then q/k/v and gate|up fused."""
    sd = hf_untied.state_dict()
    jc, tc = _tiny_configs(False, weight_quant)
    jp = j_from_state_dict(jc, sd, 64, dtype=jnp.float32)
    tp = params_from_state_dict(tc, sd, 64, device="cpu")
    eager = (jllama.quantize_weight if weight_quant == "int8"
             else jllama.quantize_weight4)
    lw = tp.layers
    assert lw.wq is None and lw.w_gate is None
    fused = {"wqkv": ("wq", "wk", "wv"), "w_gateup": ("w_gate", "w_up"),
             "wo": ("wo",), "w_down": ("w_down",)}
    for name, parts in fused.items():
        got = getattr(lw, name)
        for i in range(tc.num_hidden_layers):
            want = [eager(getattr(jp.layers, p)[i]) for p in parts]
            np.testing.assert_array_equal(
                _np(got.q[i]), np.concatenate([np.asarray(w.q) for w in want], -1))
            np.testing.assert_array_equal(
                _np(got.scale[i]),
                np.concatenate([np.asarray(w.scale) for w in want], -1))
    want = eager(jp.lm_head)
    np.testing.assert_array_equal(_np(tp.lm_head.q), np.asarray(want.q))
    np.testing.assert_array_equal(_np(tp.lm_head.scale), np.asarray(want.scale))


# -- the .npz checkpoint loader ------------------------------------------------


def _npz_configs(name: str):
    """The JAX and port configurations of a checkpoint under data/ (float32,
    as `examples/train_needle.py` and `examples/train_ruler_lm.py` train
    them) and the JAX loader."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        from train_needle import load_params as j_load_params
        from train_needle import model_config
    finally:
        sys.path.remove(str(ROOT / "examples"))
    jc = model_config()
    if name == "ruler_lm_v2":     # train_ruler_lm.py's model_config
        jc = dataclasses.replace(
            jc, name="ruler-byte-lm", vocab_size=320, intermediate_size=1024,
            num_hidden_layers=6, rope_theta=100000.0,
            max_position_embeddings=65536, eos_token_ids=(2,))
    tc = ModelConfig(**{f.name: getattr(jc, f.name)
                        for f in dataclasses.fields(ModelConfig)
                        if f.name != "dtype"}, dtype=torch.float32)
    return jc, tc, j_load_params


@pytest.mark.parametrize("name,max_len", [("needle_ckpt", 8192),
                                          ("needle_ckpt", 1280),
                                          ("ruler_lm_v2", 8192)])
def test_npz_loader_matches_jax_load_params(name, max_len):
    """data/needle_ckpt.npz (saved before the fused slots existed) and
    data/ruler_lm_v2.npz (saved with them: the other structure string),
    each with RoPE caches for 8192 positions: every weight exactly; at
    8192 the saved caches exactly, at 1280 computed anew by each
    package."""
    jc, tc, j_load_params = _npz_configs(name)
    path = ROOT / "data" / f"{name}.npz"
    jp = j_load_params(str(path), jc, max_len)
    tp = load_params(path, tc, max_len, device="cpu")
    _assert_same_params(tp, jp, rope_tol=None if max_len == 8192 else F32)
    assert tp.cos.shape == (max_len, tc.head_dim)
    assert tp.layers.wq.dtype == torch.float32


@pytest.mark.parametrize("fault", ["n", "treedef", "shape"])
def test_npz_loader_refuses_another_structure(fault, tmp_path):
    _, tc, _ = _npz_configs("needle_ckpt")
    data = dict(np.load(NEEDLE))
    if fault == "n":
        data["n"] = np.asarray(len(NPZ_LEAVES) + 1)
        data[f"leaf_{len(NPZ_LEAVES)}"] = np.zeros(1, np.float32)
    elif fault == "treedef":
        data["treedef"] = np.asarray(str(data["treedef"]).replace(
            "[*, *, *, *, *, *, *, *, *]", "[*, *, *, *, *, *, *, *]"))
    else:
        data["leaf_3"] = data["leaf_3"][:, :, :256]   # wq of 4 heads
    path = tmp_path / "bad.npz"
    np.savez(path, **data)
    with pytest.raises(ValueError, match={"n": "leaves", "treedef": "structure",
                                          "shape": "wq"}[fault]):
        load_params(path, tc, 1280, device="cpu")


# -- HF logit parity at head dim 128 -------------------------------------------


def test_full_attention_engine_matches_hf_at_head_dim_128(hf_untied):
    """tests/test_engine.py's HF parity at d = 128, group 4: the port's K=0
    CPU engine from `params_from_state_dict` against `LlamaForCausalLM` on
    the same weights: the prefill's last logits, then 8 greedy tokens
    against `generate`."""
    _, tc = _tiny_configs(False)
    params = params_from_state_dict(tc, hf_untied.state_dict(), 256,
                                    device="cpu")
    llm = LLM(tc, batch_size=1, max_length=256, params=params,
              lsh=LSHConfig(K=0, L=0, num_sink_tokens=4, num_local_tokens=16,
                            generation_buffer=32), device="cpu")
    prompt = np.random.default_rng(0).integers(1, tc.vocab_size, 100)
    logits = llm.prefill(prompt)
    ids = torch.tensor(prompt[None].astype(np.int64))
    with torch.no_grad():
        hf_last = hf_untied(ids).logits[0, -1]
    np.testing.assert_allclose(_np(logits[0]), _np(hf_last), rtol=2e-3,
                               atol=2e-3)
    tok = int(logits[0].argmax())
    ours = [tok]
    for _ in range(7):
        tok = int(llm.inference(np.asarray([tok]))[0].argmax())
        ours.append(tok)
    with torch.no_grad():
        hf_tokens = hf_untied.generate(ids, max_new_tokens=8, do_sample=False,
                                       pad_token_id=0)[0, len(prompt):].tolist()
    assert ours == hf_tokens
