"""Small versions of the benchmark's cells for tests on the host."""

from portbench.harness import cell_spec

CELLS = ("tx50-mono2.reads", "tx50-mono2.kmers")


def small_spec(name: str, n_genes: int = 60, **mix) -> dict:
    """The cell ``name`` over ``n_genes`` genes with a small pool, every
    lane within the phase-2 capacity."""
    mix = {"chunks": 2, "lanes": 4096, "reads_per_chunk": 256, "pool": 3, "trace_batches": 3,
           **mix}
    cap = {"m2": mix["reads_per_chunk"] * 120 if name.endswith(".reads") else mix["lanes"]}
    return cell_spec(name, {"config": {"n_genes": n_genes}, "mix": mix, "capacity": cap})
