"""setup_s (s): from the start of the process to the first timed group:
imports, the kernels' build or load, the stream, the session, the warm-up."""


def read(rec):
    return rec.setup_s
