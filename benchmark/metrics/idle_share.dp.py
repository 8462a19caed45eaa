"""The share of the traced window in which no kernel ran on the card (one
less the union of the kernels' intervals over the window), in percent."""


def read(layer: dict):
    bd = layer.get("breakdown")
    if not bd or not bd["busy_s"]:
        return None
    return 100 * bd["idle_share"]
