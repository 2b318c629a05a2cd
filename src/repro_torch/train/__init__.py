"""Training: ZeRO-1 gradient sync through the PAX ABI and the train step."""
