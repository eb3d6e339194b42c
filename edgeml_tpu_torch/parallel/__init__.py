"""Host-side training utilities: windowed metric meters."""
