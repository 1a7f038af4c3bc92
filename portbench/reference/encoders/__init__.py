"""Plain float32 encoders, one file each, named by a configuration file's
"encoder" key. Each gives `shapes(cfg, audio)` (its checkpoint names and
shapes, from the file's "model" and "audio"), `query_width(cfg)` (its
attention heads' width) and `encode(p, feats, cfg, drop, num)` →
(B, C, T, d_model) decoder memory."""
