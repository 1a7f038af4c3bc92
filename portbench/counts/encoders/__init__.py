"""Operation counts of the encoders, one file each, named by a
configuration file's "encoder" key: `forward(cfg, audio, segments)`."""
