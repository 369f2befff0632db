"""kernel_load_s (s): the first load of the program's kernel library, the
program's ``lu.setup.kernels`` span (source hash, ``dlopen``, argument
types), with the ``nvcc`` build inside it in a checkout's first run, from
the program's registry."""

from h100_bench import spans


def read(run):
    return spans.registry_s("lu.setup.kernels")
