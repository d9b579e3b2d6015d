"""device: the traced stretch's share in which no kernel or copy ran."""


def read(layer):
    st = layer.get("stretch")
    return None if not st else 100.0 * (1.0 - st["st"].busy_s / st["st"].wall_s)
