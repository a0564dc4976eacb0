"""weight_casts.serve: the parameter casts a replay of the serving program
adds (its `weight_cast` count in swinwnet_tpu_torch/utils/profiling.py's
graph_counts: linear, conv2d, the fused blocks' and the cross-attention's
weights to the compute dtype), a call. Read where the run captured one
graph."""

from benchmark.readers import program_ring


def read(run):
    counts = program_ring.one_graph_counts(run)
    return None if counts is None else counts.get("weight_cast")
