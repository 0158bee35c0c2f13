"""Failpoint sites of the chaos fabric (the reference's chaos/ package),
as a stand-in that never fires.

The port's I/O code calls ``failpoint`` where the reference does, so the
sites exist once the fabric is ported (ROADMAP A14); until then
``Config.chaos_spec`` is refused by the trainer and nothing arms them.
"""

from __future__ import annotations


def failpoint(site: str) -> None:
    """An injection site named ``site``: a no-op while the fabric is
    not ported."""
