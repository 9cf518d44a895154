"""The port's wave decode ms a batch of the measured query window: the
`wave_decode` spans that the generator logs from the port's
`last_wave_seconds`, summed over the window's batches and divided by
their number. None off the card, or where no batch of the window ran a
wave decode."""


def read(run):
    if run.entry != "query" or run.peak_bytes is None:
        return None
    measured = {i for i, s in enumerate(run.spans.items)
                if s["name"] == "batch" and not s.get("warmup")
                and not s.get("traced")}
    waves = [s["seconds"] for s in run.spans.items
             if s["name"] == "wave_decode" and s.get("parent") in measured]
    if not waves:
        return None
    return 1e3 * sum(waves) / len(measured)
