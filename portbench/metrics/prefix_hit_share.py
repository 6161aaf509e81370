"""Share of the window's prompt tokens the prefix cache served: the sum of
``Request.cached_prompt_tokens`` over the sum of prompt lengths, of the
requests sent in the window."""


def read(record):
    total = sum(r["prompt"] for r in record["requests"])
    if not total:
        return None
    return 100.0 * sum(r["cached"] for r in record["requests"]) / total
