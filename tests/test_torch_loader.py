"""The port's local-checkpoint path against the JAX package's: the
safetensors reader and `load_checkpoint` (models/loader.py), the chat
templates (models/template.py), `get_tokenizer` (utils/tokenizer.py) and
the generation entry point (examples/generation_torch.py), on the CPU. No
download: checkpoints are written from random-weight `transformers`
models, and the fast tokenizer is built offline with `tokenizers`.

Tolerances: configs, weights and token ids exactly (the same float32
values cast to the same dtype; bf16 and f16 files bit for bit as the
`safetensors` package reads them); quantized weights exactly against the
JAX package's eager quantizers on the JAX loader's float32 weights (its
jitted quantizer rounds one scale in some rows by an ulp,
tests/test_torch_presets.py); RoPE caches 1e-4, as
tests/test_torch_presets.py holds them.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import load_file as load_torch
from safetensors.torch import save_file as save_torch

from magicpig_tpu.models import llama as jllama
from magicpig_tpu.models.loader import load_checkpoint as j_load_checkpoint
from magicpig_tpu.models.template import Templates as JTemplates
from magicpig_tpu.utils.tokenizer import ByteTokenizer as JByteTokenizer
from magicpig_tpu.utils.tokenizer import get_tokenizer as j_get_tokenizer
from magicpig_tpu_torch.models.loader import SafetensorsFiles, load_checkpoint
from magicpig_tpu_torch.models.template import Templates
from magicpig_tpu_torch.utils.tokenizer import ByteTokenizer, get_tokenizer

ROOT = Path(__file__).resolve().parents[1]
F32 = 1e-4
LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
SHAPE = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
             num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2,
             head_dim=16, rms_norm_eps=1e-5, rope_theta=10000.0,
             max_position_embeddings=4096)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _hf_mistral(tie: bool, window=400):
    """A random-weight HF Mistral at the tiny shape, float32."""
    from transformers import MistralConfig, MistralForCausalLM

    torch.manual_seed(3)
    cfg = MistralConfig(**SHAPE, sliding_window=window, tie_word_embeddings=tie,
                        eos_token_id=2)
    return MistralForCausalLM(cfg).eval()


def _write_checkpoint(path: Path, model, sharded: bool, tie: bool,
                      dtype=None) -> dict:
    """config.json and the state dict as *.safetensors (two shards: the
    layers' weights in the first, the rest in the second, named so that
    sorted order is the write order). f32 through `safetensors.numpy`, any
    other torch dtype through `safetensors.torch`. Returns the tensors
    written."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(model.config.to_dict()))
    sd = {k: v.detach().clone().contiguous()
          for k, v in model.state_dict().items()}
    if tie:
        sd.pop("lm_head.weight")      # as HF saves a tied model
    if dtype is not None:
        sd = {k: v.to(dtype) for k, v in sd.items()}
    names = sorted(sd)
    shards = ([[n for n in names if ".layers." in n],
               [n for n in names if ".layers." not in n]]
              if sharded else [names])
    for i, shard in enumerate(shards):
        fname = path / f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        if dtype is None:
            save_numpy({n: sd[n].numpy() for n in shard}, str(fname))
        else:
            save_torch({n: sd[n] for n in shard}, str(fname))
    return sd


def _fields(cfg) -> dict:
    from magicpig_tpu_torch.config import ModelConfig
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)
            if f.name != "dtype"}


def _assert_same_params(tp, jp):
    for name in LAYER_WEIGHTS + ("ln_attn", "ln_mlp"):
        np.testing.assert_array_equal(_np(getattr(tp.layers, name).float()),
                                      np.asarray(getattr(jp.layers, name),
                                                 np.float32))
    for name in ("embed", "lm_head", "final_ln"):
        np.testing.assert_array_equal(_np(getattr(tp, name).float()),
                                      np.asarray(getattr(jp, name), np.float32))
    for name in ("cos", "sin"):
        np.testing.assert_allclose(_np(getattr(tp, name)),
                                   np.asarray(getattr(jp, name)), atol=F32,
                                   rtol=F32)


# -- load_checkpoint -----------------------------------------------------------


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("tie", [False, True])
def test_f32_checkpoint_loads_as_jax(tmp_path, sharded, tie):
    """An f32 checkpoint from `safetensors.numpy`: the same config (its
    sliding window and name included) and, in float32 and in bf16, the
    same params as the JAX package's `load_checkpoint`."""
    path = tmp_path / "mistral-tiny"
    _write_checkpoint(path, _hf_mistral(tie), sharded, tie)
    tc, tp = load_checkpoint(str(path), 64, dtype=torch.float32, device="cpu")
    jc, jp = j_load_checkpoint(str(path), 64, dtype=jnp.float32)
    assert _fields(tc) == _fields(jc)
    assert tc.name == "mistral-tiny" and tc.sliding_window == 400
    assert tc.tie_word_embeddings == tie
    _assert_same_params(tp, jp)
    assert tp.layers.wq.dtype == torch.float32
    _, tb = load_checkpoint(str(path), 64, device="cpu")
    _, jb = j_load_checkpoint(str(path), 64)
    assert tb.layers.w_down.dtype == torch.bfloat16
    _assert_same_params(tb, jb)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_reader_equals_the_safetensors_package(tmp_path, dtype):
    """A bf16 (f16, f32) checkpoint from `safetensors.torch`: every tensor
    the port's reader gives equals `safetensors.torch.load_file`'s bit for
    bit, and `load_checkpoint` in that dtype holds the same values (the
    JAX package's reader, numpy, has no bfloat16)."""
    path = tmp_path / "ckpt"
    sd = _write_checkpoint(path, _hf_mistral(False), True, False, dtype=dtype)
    files = sorted(str(p) for p in path.glob("*.safetensors"))
    want = {}
    for f in files:
        want.update(load_torch(f))
    with SafetensorsFiles(files, device="cpu") as got:
        assert sorted(got) == sorted(want) == sorted(sd)
        assert len(got) == len(want) and "lm_head.weight" in got
        assert "missing.weight" not in got
        for name, w in want.items():
            g = got[name]
            assert g.dtype == w.dtype == dtype and g.shape == w.shape
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8)), name
    assert len(got) == 0          # closed: the files unmapped
    _, tp = load_checkpoint(str(path), 64, dtype=dtype, device="cpu")
    assert tp.layers.wq.dtype == dtype
    assert torch.equal(tp.layers.wq[1], sd["model.layers.1.self_attn.q_proj.weight"].T)
    assert torch.equal(tp.lm_head, sd["lm_head.weight"].T)
    assert torch.equal(tp.embed, sd["model.embed_tokens.weight"])


@pytest.mark.parametrize("weight_quant", ["int8", "int4"])
def test_weight_quant_checkpoint_quantizes_as_jax(tmp_path, weight_quant):
    path = tmp_path / "ckpt"
    _write_checkpoint(path, _hf_mistral(False), False, False)
    tc, tp = load_checkpoint(str(path), 64, dtype=torch.float32,
                             weight_quant=weight_quant, device="cpu")
    jc, jp = j_load_checkpoint(str(path), 64, dtype=jnp.float32)
    assert tc.weight_quant == weight_quant
    assert j_load_checkpoint(str(path), 64, weight_quant=weight_quant)[
        0].weight_quant == weight_quant
    eager = (jllama.quantize_weight if weight_quant == "int8"
             else jllama.quantize_weight4)
    for name in LAYER_WEIGHTS:
        got = getattr(tp.layers, name)
        for i in range(tc.num_hidden_layers):
            want = eager(getattr(jp.layers, name)[i])
            np.testing.assert_array_equal(_np(got.q[i]), np.asarray(want.q))
            np.testing.assert_array_equal(_np(got.scale[i]),
                                          np.asarray(want.scale))
    want = eager(jp.lm_head)
    np.testing.assert_array_equal(_np(tp.lm_head.q), np.asarray(want.q))


def test_no_shards_and_unread_dtypes_raise(tmp_path):
    path = tmp_path / "empty"
    path.mkdir()
    (path / "config.json").write_text(json.dumps(dict(
        SHAPE, sliding_window=None)))
    with pytest.raises(FileNotFoundError, match="safetensors"):
        load_checkpoint(str(path), 64, device="cpu")
    with pytest.raises(FileNotFoundError, match="safetensors"):
        j_load_checkpoint(str(path), 64)
    save_numpy({"x": np.zeros((3, 2), np.int32)}, str(path / "a.safetensors"))
    with pytest.raises(ValueError, match="I32"):
        SafetensorsFiles([str(path / "a.safetensors")], device="cpu")


# -- templates and tokenizers --------------------------------------------------


def test_templates_equal_jax():
    assert Templates == JTemplates


def _fast_tokenizer_dir(path: Path) -> Path:
    """A word-level fast tokenizer built offline and saved as a HF
    tokenizer directory."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["[UNK]", "<s>", "</s>", "tell", "me", "a", "story", "about",
             "tiny", "tpu", "hash", "."]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)},
                                     unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]",
                                   bos_token="<s>", eos_token="</s>")
    fast.save_pretrained(str(path))
    return path


@pytest.mark.parametrize("source", ["none", "missing", "saved"])
def test_get_tokenizer_encodes_as_jax(tmp_path, source):
    text = "tell me a story about a tiny tpu that learned to hash ."
    if source == "none":
        got, want = get_tokenizer(None), j_get_tokenizer(None)
    elif source == "missing":
        # The JAX package would ask the HF hub for a name that is no local
        # path; its fallback is the byte tokenizer the port gives here.
        got, want = get_tokenizer(str(tmp_path / "missing")), JByteTokenizer()
    else:
        path = str(_fast_tokenizer_dir(tmp_path / "tok"))
        got, want = get_tokenizer(path), j_get_tokenizer(path)
        assert type(got).__name__ == type(want).__name__ != "ByteTokenizer"
    if source != "saved":
        assert isinstance(got, ByteTokenizer)
    ids = got.encode(text)
    assert ids == want.encode(text)
    assert got.decode(ids) == want.decode(ids)


# -- the generation entry point ------------------------------------------------


def _generation_main():
    spec = importlib.util.spec_from_file_location(
        "generation_torch", ROOT / "examples" / "generation_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("model", ["preset", "checkpoint"])
def test_generation_entry_point_runs_on_the_cpu(tmp_path, capsys, model):
    """`main` of examples/generation_torch.py with --device cpu: on the
    llama-tiny preset, and on a tiny Mistral checkpoint directory (window
    400, past the default hot capacity of 384) with a prompt file of 600
    bytes, so that the window clips the offload and bounds the decode."""
    data = tmp_path / "prompt.txt"
    data.write_text("the quick brown fox jumps over the lazy dog. " * 14)
    args = ["--device", "cpu", "--G", "4", "--t", "0.0", "--data", str(data)]
    if model == "preset":
        args += ["--model", "llama-tiny", "--M", "1024"]
    else:
        path = tmp_path / "mistral-tiny"
        _write_checkpoint(path, _hf_mistral(False), False, False)
        args += ["--model", str(path), "--M", "1024", "--template",
                 "meta-llama2"]
    assert _generation_main()(args) == 0
    out = capsys.readouterr().out
    n_prompt = len(ByteTokenizer().encode(
        (JTemplates["meta-llama2"] if model == "checkpoint" else "{}").format(
            data.read_text())))
    assert f"[INFO] Prefill {n_prompt} tokens" in out
    assert "[INFO] Generate" in out and "ms/token" in out
