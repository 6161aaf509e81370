"""Mean wall time of the engine's fused decode step in the window: the
registry's ``decode_step_s`` sum over its count."""


def read(record):
    e = record["engine"]
    if not e["decode_steps"]:
        return None
    return e["decode_s"] * 1e3 / e["decode_steps"]
