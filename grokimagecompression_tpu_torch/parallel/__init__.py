"""Multi-device coding: the tile-sharded encode and decode over a mesh of
torch devices (`sharding`) and the multi-process encode with image-wide
PCRD over `torch.distributed` (`multihost`)."""
