"""Observability: the metrics registry behind the batcher's stats row.
Spans, the flight recorder, the watchdog and exporters come with
ROADMAP A14."""
