"""Tokens the cell's users received over the whole window, per second:
in a serve cell, the generated tokens delivered in the window."""


def read(record):
    return record["tokens"] / record["window_s"]
