"""AdamW in the flat ZeRO-1 layout and the per-leaf layout."""
