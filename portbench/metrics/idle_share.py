"""Share of the profiled spans in which no kernel ran on the device (the
union of kernel intervals, markers left out)."""


def read(record):
    sessions = record.get("sessions") or []
    span = sum(s["span_s"] for s in sessions)
    if not span:
        return None
    return 100.0 * (1.0 - sum(s["busy_s"] for s in sessions) / span)
