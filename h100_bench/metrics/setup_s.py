"""setup_s: seconds from the process's start to the first timed call:
imports, the card's start, kernel builds or loads, inputs and warm-up."""


def read(rec):
    return rec["setup_s"]
