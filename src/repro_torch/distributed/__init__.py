"""Distribution layer: the sharding rules and tensor-parallel
redistributions (`sharding`, `tensor_parallel`), GPipe pipelining
(`pipeline`) and the fault-tolerance runtime (`fault_tolerance`)."""
