"""Prompt encoding in the CFG layout [uncond; cond].

Counterpart of ``fresco_tpu/pipeline/text.py`` (reference
run_fresco.py:190-196).  ``HashTokenizer`` is the offline stand-in when
no CLIP vocab files are present; ``CLIPTokenizerWrapper`` imports
``transformers`` only when a tokenizer directory is given.
"""
from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np
import torch


class HashTokenizer:
    """Deterministic word -> id stand-in (NOT BPE): tests and
    random-weight runs only."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos, self.eos = 49406 % vocab_size, 49407 % vocab_size

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.max_length), self.eos, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos]
            for word in t.lower().split()[: self.max_length - 2]:
                h = int(hashlib.md5(word.encode()).hexdigest()[:8], 16)
                ids.append(h % (self.vocab_size - 3))
            ids.append(self.eos)
            out[i, : len(ids)] = ids
        return out


class CLIPTokenizerWrapper:
    def __init__(self, tokenizer_path: str, max_length: int = 77):
        from transformers import CLIPTokenizer

        self.tok = CLIPTokenizer.from_pretrained(tokenizer_path)
        self.max_length = max_length

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        enc = self.tok(list(texts), padding="max_length", max_length=self.max_length,
                       truncation=True, return_tensors="np")
        return enc["input_ids"].astype(np.int32)


def make_tokenizer(tokenizer_path: str | None, vocab_size: int = 49408):
    if tokenizer_path:
        try:
            return CLIPTokenizerWrapper(tokenizer_path)
        except Exception:
            pass
    return HashTokenizer(vocab_size)


@torch.no_grad()
def encode_prompts(text_encoder, tokenizer, prompts: Sequence[str],
                   negative_prompts: Sequence[str], clip_skip: int = 0) -> torch.Tensor:
    """[2F, 77, C] embeddings, uncond first.  Only unique prompts go
    through the encoder; rows are gathered back afterwards."""
    texts = list(negative_prompts) + list(prompts)
    uniq = list(dict.fromkeys(texts))
    device = next(text_encoder.parameters()).device
    ids = torch.as_tensor(tokenizer(uniq).astype(np.int64), device=device)
    emb = text_encoder(ids, clip_skip=clip_skip)
    index = {t: i for i, t in enumerate(uniq)}
    return emb[torch.as_tensor([index[t] for t in texts], device=device)]
