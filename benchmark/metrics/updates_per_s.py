"""updates_per_s: SGD updates over the window, one sampled update for each
user with ratings per iteration (cu2rec's axis), over all the window's
time: jobs, their inits, warm-ups, evals, decays and finalizes included."""


def read(record):
    it = record["counters"].get("iterations", 0)
    if not it:
        return None
    return record["data"]["train_users"] * it / record["window_s"]
