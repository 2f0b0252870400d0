"""The command-line tools over the port: `compress` (grk_compress),
`decompress` (grk_decompress), `dump` (grk_dump) and `compare`; run each
as `python -m grokimagecompression_tpu_torch.cli.<tool>`."""
