"""How late the open-loop sender ran: the 95th percentile of send time
minus due time over the traced window's requests."""


def read(ctx):
    if not ctx["work"].get("requests"):
        return None
    return 1e3 * ctx["work"]["lag_p95_s"]
