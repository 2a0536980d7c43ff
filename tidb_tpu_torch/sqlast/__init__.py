"""SQL AST pieces the coprocessor protocol shares (operator codes)."""
