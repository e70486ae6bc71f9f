"""Traffic and inputs made from a run's seed: speech-like audio, the clip
cycle, the live sessions' schedule, the face scene and the training
panels."""
