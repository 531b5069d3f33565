"""setup_s: seconds from the start of the process to the opening of the
window: imports, the data drawn on the card, the program's set-up, the
kernels loaded (built on a checkout's first run) and the warm-up."""


def read(record):
    return record["setup_s"]
