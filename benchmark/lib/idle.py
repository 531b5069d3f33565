"""The device's idle share of a traced window."""


def idle_pct(record):
    trace = record["trace"]
    if trace is None or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
