"""Host-side data loading (decode, letterbox resize, batch prefetch)."""
