"""Command-line tools of the port: ``precalc_stats`` (FID reference
statistics) and ``quality_run.sh`` (the quality runbook)."""
