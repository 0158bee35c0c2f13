"""Failpoint sites of the chaos fabric (the reference's chaos/ package),
as a stand-in that never fires.

The port's I/O and serving code calls ``failpoint`` where the reference
does, so the sites exist once the fabric is ported (ROADMAP A14); until
then ``Config.chaos_spec`` is refused by the trainer and the serve CLI
and nothing arms them.  ``ChaosError`` is the reference's type, so the
serving tier's handlers name it as the reference's do; nothing raises
it here.
"""

from __future__ import annotations


class ChaosError(RuntimeError):
    """An injected fault (the reference's chaos/registry.py type).
    Never raised while the fabric is not ported."""

    def __init__(self, site: str, hit: int):
        super().__init__(
            f"chaos: injected fault at failpoint {site!r} (hit {hit})"
        )
        self.site = site
        self.hit = hit


def failpoint(site: str) -> None:
    """An injection site named ``site``: a no-op while the fabric is
    not ported."""
