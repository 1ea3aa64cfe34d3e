"""The port's CLIP tokenizer and CLIP text encoder against the reference's, on the CPU.

The tokenizer must give the reference tokenizer's ids exactly (the
reference splits words with the `regex` package, the port with the
standard library). The text encoder runs the reference's param tree
(seeded numpy values) in float32: <= 1e-5 relative L2.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.core.config import CLIPConfig as JCLIPConfig
from emox.data import tokenizer as jtok
from emox.models import clip as jclip
from emox_torch.core.config import CLIPConfig
from emox_torch.data import tokenizer as ttok
from emox_torch.models import clip as tclip
from tests.test_torch_bridge import flax_module_params, no_kernel_launches, rel_err, torch_module  # noqa: F401 (autouse fixture)

TOL = 1e-5

PROMPTS = {
    "empty": "",
    "ascii_punctuation": "A talking head -- smiling, (calm) & bright!? [studio] {4k} #portrait @night",
    "contractions": "don't stop: it's what we'll do, you'd say; I'm sure they've, they're, he's",
    "digits": "3:45pm, 12.5%, 2024-06-01, 007, 1e-3, 42nd",
    "accents": "Héllo café naïve Ünïcödé façade ÀÉÎÕÜ smörgåsbord",
    "cjk": "日本語のテキスト 中文提示 한국어 프롬프트",
    "superscripts_fractions": "x² + y³ = ½ of ¾, ⅷ and ⑤",
    "emoji": "emoji 😀👍🏽 🇫🇷 ❤️ 🧑‍🤝‍🧑",
    "whitespace_html": "  tabs\t\tand\nnew　lines  &amp;lt;b&amp;gt; ",
    "special_tokens": "<|startoftext|>hi there<|endoftext|> 'S 'LL",
    "long_truncated": "word " * 100,
}


@pytest.mark.parametrize("text", list(PROMPTS.values()), ids=list(PROMPTS))
def test_tokenizer_ids_match_the_reference(text):
    """The fallback (byte-level) vocabulary: raw ids and padded/truncated
    [1, 77] rows, as the pipeline encodes prompts."""
    want, got = jtok.CLIPTokenizer(), ttok.CLIPTokenizer()
    assert got.is_fallback and want.is_fallback
    assert got.tokenize(text) == want.tokenize(text)
    np.testing.assert_array_equal(got.encode([text]), want.encode([text]))
    np.testing.assert_array_equal(got.encode([text, "a b"], pad=False), want.encode([text, "a b"], pad=False))
    assert got.decode(got.encode(text)[0]) == want.decode(want.encode(text)[0])


def _write_vocab(tmp_path):
    """A small HF-format vocabulary with merges, and the same merges as an
    openai-format merge list."""
    chars = list(jtok.bytes_to_unicode().values())
    merges = [("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"), ("i", "n"), ("in", "g</w>"),
              ("ï", "v"), ("1", "2")]
    tokens = chars + [c + "</w>" for c in chars] + ["".join(m) for m in merges]
    vocab = {tok: i for i, tok in enumerate(tokens + [jtok.SOT_TEXT, jtok.EOT_TEXT])}
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (hf / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n",
                                   encoding="utf-8")
    openai = tmp_path / "bpe_simple_vocab_16e6.txt"
    openai.write_text("header\n" + "\n".join(" ".join(m) for m in merges) + "\n", encoding="utf-8")
    return hf, openai


@pytest.mark.parametrize("source", ["hf_dir", "hf_vocab_json", "openai_merges", "env_var"])
def test_tokenizer_vocab_files_match_the_reference(tmp_path, monkeypatch, source):
    """The vocabulary loaders and the BPE merges, with each way of naming a
    vocabulary (a path argument or EMOX_CLIP_VOCAB)."""
    hf, openai = _write_vocab(tmp_path)
    path = {"hf_dir": hf, "hf_vocab_json": hf / "vocab.json", "openai_merges": openai, "env_var": hf}[source]
    if source == "env_var":
        monkeypatch.setenv("EMOX_CLIP_VOCAB", str(path))
        want, got = jtok.CLIPTokenizer(), ttok.CLIPTokenizer()
    else:
        want, got = jtok.CLIPTokenizer(str(path)), ttok.CLIPTokenizer(str(path))
    assert not got.is_fallback and got.vocab_size == want.vocab_size
    text = "the band is singing and thinking naïve 1234"
    assert got.tokenize(text) == want.tokenize(text)
    assert len(got.tokenize("the")) == 1  # a merge was applied
    np.testing.assert_array_equal(got.encode(text), want.encode(text))


def _clip_cfg(hidden_act: str):
    kw = dict(text_enabled=True, vocab_size=300, text_hidden_dim=32, text_layers=2, text_heads=4,
              max_positions=16, hidden_act=hidden_act)
    return JCLIPConfig(**kw), CLIPConfig(**kw)


@pytest.mark.parametrize("hidden_act", ["quick_gelu", "gelu"])
def test_clip_text_encoder_matches(hidden_act):
    """Hidden states and the EOS-pooled embedding on a batch of id rows, each
    with its EOS at another place (causal mask, both activations)."""
    jcfg, tcfg = _clip_cfg(hidden_act)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 299, (3, 12)).astype(np.int32)
    ids[0, 5], ids[1, 11], ids[2, 0] = 299, 299, 299  # the EOS id given to pooled()
    jenc = jclip.CLIPTextEncoder(jcfg)
    params = flax_module_params(jenc, jnp.asarray(ids))
    tenc = torch_module(tclip.CLIPTextEncoder(tcfg), params)
    want = jenc.apply({"params": params}, jnp.asarray(ids))
    got = tenc(torch.from_numpy(ids).long())
    assert got.shape == want.shape == (3, 12, 32)
    assert rel_err(got, want) <= TOL
    want_p = jenc.apply({"params": params}, jnp.asarray(ids), 299, method=jclip.CLIPTextEncoder.pooled)
    assert rel_err(tenc.pooled(torch.from_numpy(ids).long(), 299), want_p) <= TOL


def test_clip_attention_is_causal():
    """A later token never changes an earlier token's hidden state."""
    _, tcfg = _clip_cfg("quick_gelu")
    enc = tclip.CLIPTextEncoder(tcfg)
    from emox_torch.nn.layers import init_weights

    init_weights(enc, torch.Generator().manual_seed(0))
    ids = torch.randint(0, 300, (1, 10), generator=torch.Generator().manual_seed(1))
    ids2 = ids.clone()
    ids2[0, 7:] = (ids2[0, 7:] + 1) % 300
    a, b = enc(ids), enc(ids2)
    torch.testing.assert_close(a[:, :7], b[:, :7], rtol=0, atol=0)
    assert not torch.allclose(a[:, 7:], b[:, 7:])
