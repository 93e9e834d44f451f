"""increment.vocab_ms: the vocabulary registration of an insert (the
program's ``ac.insert.vocab`` span) per traced insert_keywords(), in
ms."""

from scanbench.harness import program


def read(run):
    return program.span_ms(run, "ac.insert.vocab", root="ac.insert")
