"""The card's mean power over the window: NVML energy over window
seconds. None where the counter was not read."""


def read(record):
    if record.get("energy_j") is None:
        return None
    return record["energy_j"] / record["window_s"]
