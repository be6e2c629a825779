"""CUDA-event ms per buffer of the cell's model minus that of an identical
model with ``bscan_flip`` and ``sinusoidal_correction`` off, over the same
ring in the same process, in turns (cell, variant, variant, cell): what
the post stages cost a steady buffer."""


def read(run):
    if not (run.cell.config["proc"]["bscan_flip"] or run.cell.config["proc"]["sinusoidal_correction"]):
        return None
    off = dict(bscan_flip=False, sinusoidal_correction=False)
    cell = [run.steady_ms()]
    variant = [run.steady_ms(**off), run.steady_ms(**off)]
    cell.append(run.steady_ms())
    return sum(cell) / 2 - sum(variant) / 2
