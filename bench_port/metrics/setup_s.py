"""setup_s: seconds from the run's start to the window's start (data,
weights, the program's build and warm-up, the first epochs)."""


def read(record):
    return record["setup_s"]
