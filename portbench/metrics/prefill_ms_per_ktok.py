"""Engine prefill time per thousand prompt tokens computed in the window:
the engine registry's ``prefill_step_s`` sum over its
``prefill_tokens_computed`` (cache hits and bucket pad excluded)."""


def read(record):
    e = record["engine"]
    if not e["prefill_tokens"]:
        return None
    return e["prefill_s"] * 1e3 / (e["prefill_tokens"] / 1e3)
