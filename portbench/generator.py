"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and a seed in, a list of sessions out.

A session is what one client sends in turn, each request after the reply
to the one before it: ``turns`` prompts, each the session's shared part
(a document of the corpus; none without a corpus) followed by a fresh part
(a question, or the whole prompt without a corpus), and each with its
answer budget.

Every seed gets the same work in the same order. The sizes (each
document's length, which document each session reads, each question's and
each answer's length) and the sessions' order come from the mix's
``shape_seed``; ``--seed`` draws every token id. A run's timing then
changes with the seed only as far as the program's work depends on the
ids themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Turn:
    prompt: np.ndarray        # int32 token ids
    max_new_tokens: int
    shared_len: int           # leading tokens: the session's document


@dataclasses.dataclass
class Session:
    doc: Optional[int]        # corpus index, None without a corpus
    turns: List[Turn]


def _uniform(rng, lo_hi, n) -> np.ndarray:
    lo, hi = lo_hi
    return rng.integers(lo, hi + 1, size=n)


def zipf_picks(rng, n_docs: int, s: float, n: int) -> np.ndarray:
    """``n`` document indices, index ``r`` with probability ∝ 1/(r+1)^s."""
    p = 1.0 / np.arange(1, n_docs + 1, dtype=np.float64) ** s
    return rng.choice(n_docs, size=n, p=p / p.sum())


def shapes(mix: Dict) -> Dict:
    """The seed-free sizes of a mix: per session its document (or None)
    and per turn (fresh tokens, answer tokens); the documents' lengths."""
    rng = np.random.default_rng(mix["shape_seed"])
    n, turns = mix["sessions"], mix["turns"]
    corpus = mix.get("corpus")
    if corpus:
        doc_lens = _uniform(rng, corpus["doc_tokens"], corpus["documents"])
        docs = zipf_picks(rng, corpus["documents"], corpus["zipf_s"], n)
        fresh = _uniform(rng, mix["question_tokens"], n * turns)
    else:
        doc_lens, docs = np.zeros(0, np.int64), [None] * n
        fresh = _uniform(rng, mix["prompt_tokens"], n * turns)
    answers = _uniform(rng, mix["answer_tokens"], n * turns)
    return {"doc_lens": doc_lens, "docs": docs,
            "fresh": fresh.reshape(n, turns),
            "answers": answers.reshape(n, turns)}


def sessions(mix: Dict, seed: int, vocab: int) -> List[Session]:
    """Every session of the mix, in the order clients take them, with
    token ids uniform over ``[1, vocab)`` drawn from ``seed``."""
    sh = shapes(mix)
    rng = np.random.default_rng([seed, 2])
    docs = [rng.integers(1, vocab, size=int(n), dtype=np.int32)
            for n in sh["doc_lens"]]
    out = []
    for i in range(mix["sessions"]):
        d = sh["docs"][i]
        base = docs[d] if d is not None else np.zeros(0, np.int32)
        turns = []
        for fresh, ans in zip(sh["fresh"][i], sh["answers"][i]):
            q = rng.integers(1, vocab, size=int(fresh), dtype=np.int32)
            turns.append(Turn(np.concatenate([base, q]), int(ans), len(base)))
        out.append(Session(None if d is None else int(d), turns))
    return out


def longest(mix: Dict) -> Tuple[int, int]:
    """(the longest prompt, the longest prompt plus answer) the mix can
    send."""
    corpus = mix.get("corpus")
    if corpus:
        p = corpus["doc_tokens"][1] + mix["question_tokens"][1]
    else:
        p = mix["prompt_tokens"][1]
    return p, p + mix["answer_tokens"][1]


def prompt_range(mix: Dict) -> Tuple[int, int]:
    """(shortest, longest) prompt the mix can send."""
    corpus = mix.get("corpus")
    if corpus:
        return (corpus["doc_tokens"][0] + mix["question_tokens"][0],
                corpus["doc_tokens"][1] + mix["question_tokens"][1])
    return tuple(mix["prompt_tokens"])


def fresh_range(mix: Dict) -> Tuple[int, int]:
    """(shortest, longest) part of a prompt past its shared document."""
    return tuple(mix["question_tokens"] if mix.get("corpus")
                 else mix["prompt_tokens"])
