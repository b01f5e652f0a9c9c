"""The port's tokenizers and TI token registration against the JAX package's.

Exact equality of ids: the port's Python tokenizer and its C++ tokenizer
(sd_lora_trainer_tpu_torch/csrc/clip_bpe.cpp, built with g++) against the
JAX package's Python tokenizer, on captions with TI tokens, merges,
truncation past 77 tokens and both pad ids (CLIP-L pads with EOS, OpenCLIP-G
with 0). Six processes that build the native library into one fresh
directory at once all load it, and one library is left. A failed build
raises with g++'s message.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_lora_trainer_tpu.models import tokenizer as jt
from sd_lora_trainer_tpu.training.embeddings import TokenEmbeddingsHandler as JHandler
from sd_lora_trainer_tpu_torch.models import tokenizer as tt
from sd_lora_trainer_tpu_torch.models import tokenizer_native as tn
from sd_lora_trainer_tpu_torch.training.embeddings import TokenEmbeddingsHandler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["photo", "style", "painting", "portrait", "object", "person", "the", "of", "a"]
TI = ["<s0>", "<s1>", "<s2>"]
CAPTIONS = [
    "",
    "a photo of <s0><s1><s2>",
    "in the style of <s0><s1><s2>, a painting of the sea",
    "TOK, a Portrait of a person,  with   spaces and punctuation!!",
    "<s1> numbers 12 and 345, it's a person's style",
    " ".join(["portrait of a person"] * 30),  # truncated at 77
]


def _vocabs():
    return {
        "test": jt.build_test_vocab(extra_words=WORDS),
        "sized": jt.build_sized_test_vocab(49408, extra_words=WORDS),
    }


@pytest.mark.parametrize("vocab_name", ["test", "sized"])
@pytest.mark.parametrize("pad", [None, 0])
@pytest.mark.parametrize("kind", ["python", "native"])
def test_ids_equal_jax(kind, pad, vocab_name):
    vocab, merges = _vocabs()[vocab_name]
    ref = jt.CLIPTokenizer(vocab, merges, pad_token_id=pad)
    cls = tt.CLIPTokenizer if kind == "python" else tn.NativeCLIPTokenizer
    tok = cls(vocab, merges, pad_token_id=pad)
    for t in (ref, tok):
        assert t.add_special_tokens(TI) == 3
    assert tok.convert_tokens_to_ids(TI) == ref.convert_tokens_to_ids(TI)
    for caption in CAPTIONS:
        assert tok.encode(caption) == ref.encode(caption), caption
    ids = tok(CAPTIONS)
    assert ids == ref(CAPTIONS)
    assert all(len(row) == 77 for row in ids)
    assert len(ref.encode(CAPTIONS[-1])) == 77


def test_ti_registration_and_positions_equal_jax():
    vocab, merges = _vocabs()["test"]
    jtoks = [jt.CLIPTokenizer(vocab, merges), jt.CLIPTokenizer(vocab, merges, pad_token_id=0)]
    ttoks = [tt.CLIPTokenizer(vocab, merges), tn.NativeCLIPTokenizer(vocab, merges, pad_token_id=0)]
    table = np.random.RandomState(0).randn(len(vocab), 16).astype(np.float32)
    jh = JHandler(tokenizers=jtoks)
    jrows = jh.initialize_new_tokens([jnp.asarray(table)] * 2, TI, jax.random.PRNGKey(0))
    th = TokenEmbeddingsHandler(tokenizers=ttoks)
    trows = th.initialize_new_tokens([torch.from_numpy(table)] * 2, TI,
                                     torch.Generator().manual_seed(0),
                                     starting_rows=[np.asarray(r) for r in jrows])
    assert th.train_ids == jh.train_ids == [len(vocab), len(vocab) + 1, len(vocab) + 2]
    for i in (0, 1):
        np.testing.assert_allclose(th.std_token_embedding[i], jh.std_token_embedding[i], rtol=1e-6)
        np.testing.assert_array_equal(trows[i].detach().numpy(), np.asarray(jrows[i]))
        assert trows[i].requires_grad
    for caption in CAPTIONS:
        assert th.ti_token_positions(caption) == jh.ti_token_positions(caption), caption
    j_near = JHandler.nearest_tokens(jrows[0], jnp.asarray(table), jtoks[0], k=3)
    assert TokenEmbeddingsHandler.nearest_tokens(trows[0], torch.from_numpy(table), ttoks[0],
                                                 k=3) == j_near


def test_embeddings_file_round_trip(tmp_path):
    vocab, merges = _vocabs()["test"]
    th = TokenEmbeddingsHandler(tokenizers=[tt.CLIPTokenizer(vocab, merges), None])
    table = torch.randn(len(vocab), 8, generator=torch.Generator().manual_seed(1))
    rows = th.initialize_new_tokens([table, None], TI, torch.Generator().manual_seed(2))
    assert rows[1] is None
    path = str(tmp_path / "emb.safetensors")
    th.save_embeddings(rows, path)
    back = TokenEmbeddingsHandler.load_embeddings(path)
    assert list(back) == ["clip_l"] and torch.equal(back["clip_l"], rows[0].detach())
    from sd_lora_trainer_tpu.training.embeddings import TokenEmbeddingsHandler as J

    np.testing.assert_array_equal(J.load_embeddings(path)["clip_l"], rows[0].detach().numpy())


def test_concurrent_native_builds_all_load(tmp_path):
    """Six processes build into one empty directory at once; each loads the
    library and tokenizes, and one library and no temporary file is left."""
    build = tmp_path / "build"
    go = tmp_path / "go"
    code = textwrap.dedent(f"""
        import os, sys, time
        from pathlib import Path
        sys.path.insert(0, {ROOT!r})
        from sd_lora_trainer_tpu_torch.models import tokenizer as tt
        from sd_lora_trainer_tpu_torch.models import tokenizer_native as tn
        tn.BUILD_DIR = Path({str(build)!r})
        while not os.path.exists({str(go)!r}):
            time.sleep(0.01)
        vocab, merges = tt.build_test_vocab(extra_words=["photo"])
        tok = tn.NativeCLIPTokenizer(vocab, merges)
        print(tok.encode("a photo"))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(6)]
    go.write_text("")
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    assert len({o[0] for o in outs}) == 1
    vocab, merges = tt.build_test_vocab(extra_words=["photo"])
    assert outs[0][0].strip() == str(jt.CLIPTokenizer(vocab, merges).encode("a photo"))
    assert sorted(p.name for p in build.iterdir() if not p.name.startswith(".")) == [
        tn.library_path().name]


def test_failed_build_raises_with_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "clip_bpe.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tn, "SRC", bad)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        tn.build_library()
    assert not any(p.suffix in (".so", ".tmp") for p in (tmp_path / "build").iterdir())
