"""Failpoint sites of the chaos fabric (the reference's chaos/ package),
as a stand-in that never fires.

The port's I/O and serving code calls ``failpoint`` where the reference
does, so the sites exist once the fabric is ported (ROADMAP A14); until
then ``Config.chaos_spec`` is refused by the trainer and the serve CLI
and nothing arms them.  ``ChaosError`` is the reference's type, so the
serving tier's handlers name it as the reference's do; nothing raises
it here.

``retry_call`` is the reference's bounded retry (chaos/heal.py:59-94):
the tiered store's cold fetch and write-back call it at the reference's
sites, so a transient ``OSError`` heals there with the same backoff, a
``<channel>.retries`` counter per retry and one ``recovered:io_retry``
health row.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from xflow_tpu_torch.obs import emit_health

# exponential backoff is capped so a misconfigured retry count can
# never park a hot path for more than ~a second per attempt
BACKOFF_CAP_S = 1.0


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


def retry_call(
    fn: Callable[[], Any],
    *,
    attempts: int,
    backoff_s: float,
    channel: str,
    site: str,
    obs,
    retry_on: tuple = (OSError, ChaosError),
) -> Any:
    """Call ``fn`` with up to ``attempts`` retries on ``retry_on``
    (exponential backoff, capped at :data:`BACKOFF_CAP_S`).  A call
    that eventually succeeds after failures books a
    ``<channel>.retries`` counter per retry and ONE
    ``recovered:io_retry`` health row; exhausted retries re-raise the
    last error for the caller's quarantine/abort policy."""
    failures = 0
    while True:
        try:
            out = fn()
        except retry_on:
            failures += 1
            if failures > attempts:
                raise
            obs.counter(f"{channel}.retries")
            time.sleep(min(backoff_s * 2.0 ** (failures - 1), BACKOFF_CAP_S))
            continue
        if failures:
            emit_health(
                obs,
                cause="recovered:io_retry",
                channel=channel,
                detail=f"{site}: healed after {failures} retried "
                f"failure(s)",
            )
        return out
