"""Fault injection and the serving decode guard."""
