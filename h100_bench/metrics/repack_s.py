"""repack_s (s): the re-packs of the run's construction, the program's
``lu.setup.device`` spans (the factors onto the card's tiles, the solve
plans; once more where the refactor plan re-tiles them), from the
program's registry."""

from h100_bench import spans


def read(run):
    return spans.registry_s("lu.setup.device")
