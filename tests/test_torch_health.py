"""The port's node metrics plane against the JAX package's, on the CPU.

The port's ``metrics.py`` is now a whole copy of the reference's, so
``tests/test_health.py`` (the health rules, ``HealthMonitor``, the
``/healthz`` route) and ``tests/test_metrics.py`` (the instruments, the
``SnapshotWriter``, the ``MetricsServer`` endpoint, the node's JSON log
formatter, the detection counters' node scope) run again on the port."""

from tests.test_torch_tasks import mirror

MIRRORED_HEALTH = mirror(globals(), "test_health")
MIRRORED_METRICS = mirror(globals(), "test_metrics")


def test_mirrors_cover_the_reference_cases():
    assert len(MIRRORED_HEALTH) == 19
    assert len(MIRRORED_METRICS) == 19
    assert {"test_snapshot_writer_atomic", "test_metrics_http_endpoint",
            "test_node_scope_attributes_detection_counters"} <= set(MIRRORED_METRICS)
