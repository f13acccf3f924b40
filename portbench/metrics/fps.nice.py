"""fps.nice (frames/s): frames stepped in the window's untraced stretch over
its seconds, closed by a synchronise: ``fps`` of a host-bound cell, read in
a ``--trace 1`` run, where its spread from run to run holds no bound."""


def read(r):
    u = r["untraced"]
    if u["frames"] <= 0 or u["seconds"] <= 0:
        return None
    return u["frames"] / u["seconds"]
