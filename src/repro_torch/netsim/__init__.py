"""Stateful network simulator: bursty Gilbert–Elliott loss, the AR(1)
bandwidth walk and deadline delivery, as scenario axes of the round."""
