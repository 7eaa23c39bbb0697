"""Distribution layer: the fault-tolerance runtime (sharding and
pipeline parallelism are not ported yet)."""
