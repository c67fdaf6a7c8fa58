"""Shared-prefix KV reuse: trie index, refcounted spans, COW pages."""
from repro_torch.prefix.index import PrefixIndex, PrefixNode, block_key

__all__ = ["PrefixIndex", "PrefixNode", "block_key"]
