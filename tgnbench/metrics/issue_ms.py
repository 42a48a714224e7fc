"""issue_ms (session): the median host time of a round inside
``SessionManager.step``, from the call to its return (the round's staging
and launches; the device is not waited for), over the untraced window of
the traced run."""
import statistics


def read(r):
    return statistics.median(r.issue_s) * 1e3 if r.issue_s else None
