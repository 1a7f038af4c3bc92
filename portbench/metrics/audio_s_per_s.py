"""Seconds of song transcribed per wall second: the audio of every song
completed in the window over the window's whole time (host clock)."""


def read(run):
    if "audio_s" not in run.counts or run.window_s <= 0:
        return None
    return run.counts["audio_s"] / run.window_s
