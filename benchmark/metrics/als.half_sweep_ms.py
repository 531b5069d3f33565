"""als.half_sweep_ms: the program's own CUDA-event time of each sweep's
two half sweeps (``train_als``'s ``half_sweep_ms`` eval extras), summed a
sweep, averaged over the window's sweeps."""


def read(record):
    ms = record.get("half_sweep_ms") or []
    return sum(ms) / len(ms) if ms else None
