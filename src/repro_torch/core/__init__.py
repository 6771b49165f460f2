"""Framework-free core: the DASH schedules (numpy only), the paper's
schedule model over them (Gantt simulator, DAG and Lemma 1, ASCII charts)
and the pinned-order reductions."""
