"""The official VQA accuracy metric (counterpart of
`robustvlm_tpu/vlm_eval/metrics/vqa_accuracy.py`, copied: the port imports
nothing of the JAX package).

Answers are normalized (punctuation stripped with the comma/period rules,
digit words to digits, articles dropped, contractions restored); a
prediction's accuracy is min(#matching annotators / 3, 1) against the other
9 annotators, averaged over the 10 leave-one-out subsets. The word tables
are the published VQA-evaluation data constants.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
    "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's", "whatve": "what've",
    "whens": "when's", "whered": "where'd", "wheres": "where's", "whereve": "where've",
    "whod": "who'd", "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll", "whyre": "why're",
    "whys": "why's", "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've", "yall": "y'all",
    "yall'll": "y'all'll", "y'allll": "y'all'll", "yall'd've": "y'all'd've",
    "y'alld've": "y'all'd've", "y'all'dve": "y'all'd've", "youd": "you'd",
    "youd've": "you'd've", "you'dve": "you'd've", "youll": "you'll",
    "youre": "you're", "youve": "you've",
}

DIGIT_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

ARTICLES = {"a", "an", "the"}

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
PUNCT = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or (
            re.search(_COMMA_STRIP, text) is not None
        ):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out, re.UNICODE)
    return out


def process_digit_article(text: str) -> str:
    out = []
    for word in text.lower().split():
        word = DIGIT_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in CONTRACTIONS:
            out[i] = CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(ans))


def vqa_accuracy(
    prediction: str, gt_answers: Sequence[str]
) -> float:
    """Official leave-one-out accuracy over the (typically 10) annotator
    answers."""
    pred = normalize_answer(prediction)
    gts = [normalize_answer(a) for a in gt_answers]
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1:]
        matches = sum(1 for o in others if o == pred)
        accs.append(min(matches / 3.0, 1.0))
    return sum(accs) / max(len(accs), 1)


def compute_vqa_accuracy(
    results: Sequence[Dict],
    annotations: Dict,
    return_individual_scores: bool = False,
):
    """results: [{'question_id', 'answer'}]; annotations maps question_id ->
    list of annotator answers (reference vqa_metric.compute_vqa_accuracy
    :527-580)."""
    per = {}
    for r in results:
        qid = r["question_id"]
        per[qid] = vqa_accuracy(r["answer"], annotations[qid])
    mean = 100.0 * sum(per.values()) / max(len(per), 1)
    if return_individual_scores:
        return mean, per
    return mean


def load_vqa_annotations(annotations_path: str) -> Dict:
    """Official VQAv2 annotations json -> {question_id: [10 answers]}."""
    with open(annotations_path) as f:
        data = json.load(f)
    anns = data["annotations"] if isinstance(data, dict) else data
    return {
        a["question_id"]: [x["answer"] for x in a["answers"]]
        for a in anns
    }


def postprocess_vqa_generation(prediction: str) -> str:
    """Cut at the first newline/'Question'/'Answer' marker (reference
    vqa_metric.postprocess_vqa_generation semantics)."""
    for sep in ("\n", "Question", "Answer", "Short answer"):
        prediction = prediction.split(sep, 1)[0]
    return prediction.strip()
