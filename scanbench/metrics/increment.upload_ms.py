"""increment.upload_ms: the table uploads and scatters of a refresh (the
program's ``ac.upload`` spans) per traced refresh(), in ms."""

from scanbench.harness import program


def read(run):
    return program.span_ms(run, "ac.upload", root="ac.refresh")
