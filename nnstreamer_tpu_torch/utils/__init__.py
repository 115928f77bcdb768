"""Small helpers shared by the elements."""
