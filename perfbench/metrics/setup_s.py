"""Set-up seconds: from the start of the process to the end of the
warm-up (imports, CUDA context, kernel build or load, volume on the
device, one short solution)."""


def read(run):
    return run["setup_s"]
