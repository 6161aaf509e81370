"""Faults planted in the program's timed path, to see ``correct`` come out
false: a token altered where it is produced. The CPU check tests plant
them in a whole run at a small size; ``control.py --fault`` reads them at
a cell's own size on the card."""
from __future__ import annotations

import contextlib

PLACES = ("decode", "prefill")


@contextlib.contextmanager
def altered(place: str, vocab: int):
    """Within the block, every token that the paged adapter's decode steps
    (``place`` "decode") or prefills ("prefill") produce is replaced by the
    next id of the vocabulary."""
    from repro_torch.serve.state import PagedKVAdapter
    name = {"decode": "decode_step", "prefill": "prefill"}[place]
    orig = getattr(PagedKVAdapter, name)

    def decode_step(self, tokens, pos):
        return (orig(self, tokens, pos) + 1) % vocab

    def prefill(self, slot, req):
        out = orig(self, slot, req)
        if out.first_token is not None:
            out.first_token = (out.first_token + 1) % vocab
        return out

    setattr(PagedKVAdapter, name, locals()[name])
    try:
        yield
    finally:
        setattr(PagedKVAdapter, name, orig)
