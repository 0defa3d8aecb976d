"""Host-side data loading."""
