"""The card's measured energy over the window (NVML's counter), per token
of ``tok_s``. None where the counter was not read."""


def read(record):
    if record.get("energy_j") is None or not record["tokens"]:
        return None
    return record["energy_j"] / record["tokens"]
