"""Device (H100): the share of the traced window in which no operation
ran on the card (one minus the union of the device events' intervals
over the window), in percent."""


def read(record):
    dev = record.get("device")
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
