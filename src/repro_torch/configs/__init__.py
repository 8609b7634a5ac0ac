"""Model configurations the port can build (the paper's pairs)."""
