"""ingest_gb_per_s (metrics/ingest_gb_per_s.py) in the cells whose rate is
the card's, where the host-to-device copies are most of the card's time."""

from harness import spec


def read(run):
    return spec.reader("ingest_gb_per_s")(run)
