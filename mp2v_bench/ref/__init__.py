"""Frozen numpy copies of the port's golden model, Python tokenizer, VLC
tables and headers, at commit fcc0a56b588b: the benchmark's plain
reference."""
