"""One reader a metric family: ``<family>.py`` with ``read(run, name)``,
returning the metric's value, or None where the run holds nothing to read
(the harness then leaves the metric out of the line)."""
