"""Host-clock mean of one ``process_buffer`` call in the window, from the
harness's own span around it (dispatched ahead: the host's cost of a
buffer, not the card's), in ms."""


def read(run):
    if not run.spans:
        return None
    return 1e3 * sum(run.spans) / len(run.spans)
