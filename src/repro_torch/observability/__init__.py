"""Observability: the span trace (``trace``) that ``LifecycleManager.tick``
records into.  The load monitor, metrics, export and alarms of
``repro.observability`` are not ported yet."""
