"""Step and graph: the seconds the step's CUDA-graph captures took in
set-up (the program's `TrainStep.captures()`)."""


def read(m):
    caps = m["captures"]
    return sum(c["capture_s"] for c in caps) if caps else None
