"""One reader a per-layer metric: ``<metric name>.py`` defines
``read(run)``, which returns a number or None (nothing to read).
Files whose names start with ``_`` are shared arithmetic, not metrics."""
