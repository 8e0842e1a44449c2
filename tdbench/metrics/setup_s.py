"""``setup_s``: seconds from the start of ``run.py`` to the end of warm-up,
less the making of the benchmark's own data (the stand-in vocabulary and
the units): imports, the CUDA context, the kernels, the tokenizer and its
tables, warm-up."""


def read(run):
    return run.setup_s
