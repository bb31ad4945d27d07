"""Vehicle motion and range-bearing sensor models."""
