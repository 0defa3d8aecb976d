"""Task trainers."""
