"""What the span readers share: the program's span ring and graph counts
(swinwnet_tpu_torch/utils/profiling.py), or None with a note where the
program has none."""


def _profiling(run):
    from swinwnet_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        run.note(f"{run.metric['name']}: the program keeps no span ring")
        return None
    return profiling


def unprofiled(run):
    """The ring's records made with no profiler recording."""
    profiling = _profiling(run)
    return None if profiling is None else [r for r in profiling.spans() if not r.profiled]


def one_graph_counts(run):
    """The counts a replay adds, of the run's one captured graph."""
    profiling = _profiling(run)
    if profiling is None:
        return None
    graphs = [(name, c) for name, cs in profiling.graph_counts().items() for c in cs]
    if len(graphs) != 1:
        run.note(f"{run.metric['name']}: {len(graphs)} captured graphs ({[n for n, _ in graphs]}), not one")
        return None
    return graphs[0][1]
